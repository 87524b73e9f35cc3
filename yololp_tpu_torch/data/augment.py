"""Host-side training augmentations with box AND corner bookkeeping.

Behavioral reference: yolov6/data/data_augment.py (augment_hsv, mixup,
random_affine, get_transform_matrix, mosaic_augmentation, box_candidates).
Every geometric transform moves the 4 plate corners through the same matrix
as the box; candidates are filtered by the 0.9 area-ratio rule.

Label layout here is the in-pipeline pixel-coordinate form:
  [:8] classes, [8:12] box x1y1x2y2 (pixels), [12:20] corners (pixels).

Copied from yololp_tpu/data/augment.py (the port imports nothing of the JAX
package); cv2 is imported inside the functions that use it, since the
machine with the card has none.
"""

from __future__ import annotations

import math
import random
from typing import List, Tuple

import numpy as np


def augment_hsv(im: np.ndarray, hgain=0.5, sgain=0.5, vgain=0.5):
    """In-place HSV jitter (data_augment.py:13-26)."""
    import cv2

    if hgain or sgain or vgain:
        r = np.random.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        hue, sat, val = cv2.split(cv2.cvtColor(im, cv2.COLOR_BGR2HSV))
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(im.dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(im.dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(im.dtype)
        im_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat),
                            cv2.LUT(val, lut_val)))
        cv2.cvtColor(im_hsv, cv2.COLOR_HSV2BGR, dst=im)


def mixup(im, labels, im2, labels2):
    """Beta(32, 32) image blend, labels concatenated (data_augment.py:63)."""
    r = np.random.beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    return im, np.concatenate((labels, labels2), 0)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """Keep boxes surviving a transform (data_augment.py:71)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def get_transform_matrix(img_shape, new_shape, degrees, scale, shear, translate):
    """Random affine matrix (data_augment.py:133)."""
    import cv2

    new_height, new_width = new_shape
    c = np.eye(3)
    c[0, 2] = -img_shape[1] / 2
    c[1, 2] = -img_shape[0] / 2

    rot = np.eye(3)
    a = random.uniform(-degrees, degrees)
    s = random.uniform(1 - scale, 1 + scale)
    rot[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)

    sh = np.eye(3)
    sh[0, 1] = math.tan(random.uniform(-shear, shear) * math.pi / 180)
    sh[1, 0] = math.tan(random.uniform(-shear, shear) * math.pi / 180)

    t = np.eye(3)
    t[0, 2] = random.uniform(0.5 - translate, 0.5 + translate) * new_width
    t[1, 2] = random.uniform(0.5 - translate, 0.5 + translate) * new_height

    return t @ sh @ rot @ c, s


def _transform_points(pts_flat: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(n, 8) corner-quad coords through a 3x3 matrix -> (n, 8)."""
    n = len(pts_flat)
    xy = np.ones((n * 4, 3))
    xy[:, :2] = pts_flat.reshape(n * 4, 2)
    xy = xy @ m.T
    return xy[:, :2].reshape(n, 8)


def random_affine(img, labels, degrees=10, translate=0.1, scale=0.1, shear=10,
                  new_shape=(640, 640)):
    """Random affine over image + boxes + corners (data_augment.py:80)."""
    import cv2

    n = len(labels)
    height, width = new_shape
    m, _ = get_transform_matrix(img.shape[:2], (height, width), degrees, scale,
                                shear, translate)
    if (m != np.eye(3)).any():
        img = cv2.warpAffine(img, m[:2], dsize=(width, height),
                             borderValue=(114, 114, 114))
    if n:
        # boxes: transform the 4 box corners, re-axis-align
        quad = labels[:, [8, 9, 10, 11, 8, 11, 10, 9]]
        xy = _transform_points(quad, m)
        x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
        new_box = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)

        new_corners = _transform_points(labels[:, 12:20], m)

        pre_clip = np.copy(new_box)
        new_box[:, [0, 2]] = new_box[:, [0, 2]].clip(0, width)
        new_box[:, [1, 3]] = new_box[:, [1, 3]].clip(0, height)
        new_corners[:, 0::2] = new_corners[:, 0::2].clip(0, width)
        new_corners[:, 1::2] = new_corners[:, 1::2].clip(0, height)

        keep = box_candidates(box1=pre_clip.T, box2=new_box.T, area_thr=0.9)
        labels = labels[keep]
        labels[:, 8:12] = new_box[keep]
        labels[:, 12:20] = new_corners[keep]
    return img, labels


def mosaic_augmentation(img_size: int, imgs: List[np.ndarray], hs, ws,
                        labels_list, hyp) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic with corner bookkeeping (data_augment.py:164).

    Incoming labels are normalized (the on-disk format); outgoing labels are
    pixel coords in the affine-cropped (img_size, img_size) canvas.
    """
    assert len(imgs) == 4
    s = img_size
    yc, xc = (int(random.uniform(s // 2, 3 * s // 2)) for _ in range(2))
    labels4 = []
    img4 = None
    for i, (img, h, w) in enumerate(zip(imgs, hs, ws)):
        if i == 0:
            img4 = np.full((s * 2, s * 2, img.shape[2]), 114, dtype=np.uint8)
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b

        lbl = labels_list[i].copy()
        if lbl.size:
            out = lbl.copy()
            out[:, 8] = w * (lbl[:, 8] - lbl[:, 10] / 2) + padw
            out[:, 9] = h * (lbl[:, 9] - lbl[:, 11] / 2) + padh
            out[:, 10] = w * (lbl[:, 8] + lbl[:, 10] / 2) + padw
            out[:, 11] = h * (lbl[:, 9] + lbl[:, 11] / 2) + padh
            out[:, 12:20:2] = w * lbl[:, 12:20:2] + padw
            out[:, 13:20:2] = h * lbl[:, 13:20:2] + padh
            lbl = out
        labels4.append(lbl)

    labels4 = np.concatenate(labels4, 0)
    pre_clip = np.copy(labels4[:, 8:12])
    labels4[:, 8:20] = labels4[:, 8:20].clip(0, 2 * s)
    keep = box_candidates(box1=pre_clip.T, box2=labels4[:, 8:12].T, area_thr=0.9)
    labels4 = labels4[keep]

    return random_affine(img4, labels4, degrees=hyp["degrees"],
                         translate=hyp["translate"], scale=hyp["scale"],
                         shear=hyp["shear"], new_shape=(img_size, img_size))
