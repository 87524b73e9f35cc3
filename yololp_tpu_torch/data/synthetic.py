"""Synthetic CCPD-like dataset writer (for smoke training, CI, and demos).

Creates the on-disk layout the reference expects (images/<split>/*.jpg +
labels/<split>/*.txt with 20-float rows) by pasting generated plates onto
procedural backgrounds. The reference has no equivalent single entry point
(its data/generate.py writes plates only); this utility makes the whole
train/eval pipeline runnable without CCPD.

Copied from yololp_tpu/data/synthetic.py (the port imports nothing of the JAX
package); cv2 and PIL are imported inside the functions that use them,
since the machine with the card has neither.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from yololp_tpu_torch.data.generate import PlateGenerator, paste_plates


def procedural_scene(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Structured procedural background: gradient sky/ground, rectangles and
    lines (car bodies, road markings), occasional signage text — distractors
    that force the detector to key on plate structure rather than 'any
    rectangle'. Stands in for the reference's NoPlates env photos
    (yolov6/data/generate/utils.py:143-157), which are not redistributable.
    """
    import cv2

    from yololp_tpu_torch.data.glyphs import render_latin

    c0 = rng.integers(20, 235, 3).astype(np.float32)
    c1 = rng.integers(20, 235, 3).astype(np.float32)
    if rng.random() < 0.5:
        t = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    else:
        t = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    img = (c0 * (1 - t) + c1 * t) * np.ones((h, w, 3), np.float32)

    for _ in range(int(rng.integers(4, 14))):  # blocks: cars, walls, windows
        x0, y0 = rng.integers(0, w), rng.integers(0, h)
        bw, bh = rng.integers(w // 16, w // 2), rng.integers(h // 16, h // 2)
        col = rng.integers(0, 255, 3).astype(np.float32)
        sub = img[y0:y0 + bh, x0:x0 + bw]
        sub[:] = sub * 0.25 + col * 0.75
    for _ in range(int(rng.integers(2, 8))):  # lines: edges, road markings
        p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        col = tuple(int(v) for v in rng.integers(0, 255, 3))
        cv2.line(img, p0, p1, col, int(rng.integers(1, 6)))
    img = np.clip(img + rng.normal(0, rng.uniform(4, 18), (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)

    if rng.random() < 0.5:  # signage distractor text
        txt = "".join(chr(int(c)) for c in rng.integers(65, 90, 6))
        size = int(rng.integers(h // 32, h // 10))
        x0, y0 = int(rng.integers(0, w - 6 * size)), int(rng.integers(0, h - size))
        col = tuple(int(v) for v in rng.integers(0, 255, 3))
        for i, ch in enumerate(txt):
            g = render_latin(ch, size * 3 // 5, size)
            gh, gw = g.shape
            x = x0 + i * (gw + 2)
            if x + gw >= w:
                break
            a = g.astype(np.float32)[..., None] / 255.0
            roi = img[y0:y0 + gh, x:x + gw].astype(np.float32)
            img[y0:y0 + gh, x:x + gw] = (
                roi * (1 - a) + np.float32(col) * a).astype(np.uint8)
    if rng.random() < 0.3:  # empty bordered rectangle (plate-shaped decoy)
        rw = int(rng.integers(w // 10, w // 3))
        rh = max(rw // 3, 4)
        x0, y0 = int(rng.integers(0, w - rw)), int(rng.integers(0, h - rh))
        col = tuple(int(v) for v in rng.integers(0, 255, 3))
        cv2.rectangle(img, (x0, y0), (x0 + rw, y0 + rh), col, -1)
        cv2.rectangle(img, (x0, y0), (x0 + rw, y0 + rh), (255, 255, 255), 2)
    return cv2.GaussianBlur(img, (0, 0), rng.uniform(0.5, 1.5))


def make_synthetic_dataset(root: str, n_train: int = 64, n_val: int = 16,
                           img_size: int = 640, seed: int = 0,
                           cjk_font_path: Optional[str] = None,
                           ratio_min: float = 0.1, ratio_max: float = 0.4,
                           start: int = 0, diversity: float = 0.0) -> dict:
    """Write images/{split} + labels/{split}; returns a data dict compatible
    with load_dataset_yaml's output. `start` offsets file numbering so large
    datasets can be generated incrementally/in chunks. `diversity` enables
    per-instance glyph weathering (see PlateGenerator)."""
    import cv2

    gen = PlateGenerator(seed=seed, cjk_font_path=cjk_font_path,
                         diversity=diversity)
    for split, n in (("train", n_train), ("val", n_val)):
        # independent streams so chunked generation stays reproducible
        rng = np.random.default_rng((seed, start, split == "val"))
        gen.rng = rng
        img_dir = osp.join(root, "images", split)
        lbl_dir = osp.join(root, "labels", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        for i in range(start, start + n):
            h = w = img_size
            img = procedural_scene(rng, h, w)
            labels = np.zeros((0, 20), np.float32)
            img, labels = paste_plates(img, labels, gen, rng=rng,
                                       min_num=1, max_num=3,
                                       ratio_min=ratio_min,
                                       ratio_max=ratio_max)
            cv2.imwrite(osp.join(img_dir, f"{split}_{i:05d}.jpg"), img)
            with open(osp.join(lbl_dir, f"{split}_{i:05d}.txt"), "w") as f:
                for row in labels:
                    cls = row[:8]
                    x1, y1, x2, y2 = row[8:12]
                    cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
                    bw, bh = (x2 - x1) / w, (y2 - y1) / h
                    cors = row[12:20].copy()
                    cors[0::2] = np.clip(cors[0::2] / w, 0, 1)
                    cors[1::2] = np.clip(cors[1::2] / h, 0, 1)
                    vals = list(cls.astype(int)) + [cx, cy, bw, bh] + list(cors)
                    f.write(" ".join(f"{v:.6f}" if isinstance(v, float) else str(v)
                                     for v in vals) + "\n")
    return {"train": osp.join(root, "images", "train"),
            "val": osp.join(root, "images", "val"),
            "test": osp.join(root, "images", "val"),
            "is_coco": False, "npro": 31, "nalp": 24, "nads": 37}
