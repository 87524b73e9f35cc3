"""Host-side image IO: letterbox, loaders for image/dir/video sources
(mirrors yololp_tpu/data/images.py:22-141).

numpy on the host; cv2 is imported only where an image is resized or
decoded, so frames that only need padding go through without it.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Iterator, Tuple

import numpy as np

IMG_FORMATS = ["bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo"]
VID_FORMATS = ["mp4", "mov", "avi", "mkv"]


def letterbox(im, new_shape=(640, 640), color=114, auto=True, scaleup=True, stride=32,
              return_int=False):
    """Resize + pad to new_shape keeping aspect ratio. The border is
    constant `color` on every channel. Returns (image, ratio, pad) with pad
    the float (dw, dh), or with return_int the integer (left, top)."""
    shape = im.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    elif isinstance(new_shape, (list, tuple)) and len(new_shape) == 1:
        new_shape = (new_shape[0], new_shape[0])

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # minimum rectangle
        dw, dh = np.mod(dw, stride), np.mod(dh, stride)
    dw /= 2
    dh /= 2

    if shape[::-1] != new_unpad:
        import cv2

        im = cv2.resize(im, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    pad = ((top, bottom), (left, right)) + ((0, 0),) * (im.ndim - 2)
    im = np.pad(im, pad, mode="constant", constant_values=color)
    if return_int:
        return im, r, (left, top)
    return im, r, (dw, dh)


def check_img_size(img_size, s=32, floor=0):
    """Round img_size up to a multiple of stride s, and to at least `floor`."""
    def make_div(x):
        return max(int(math.ceil(x / s) * s), floor)

    if isinstance(img_size, int):
        new = make_div(img_size)
        return [new, new]
    return [make_div(x) for x in img_size]


def rescale_dets(dets: np.ndarray, letterbox_shape, ori_shape) -> np.ndarray:
    """Map detection boxes+corners (cols 0:12) from letterboxed to source
    coordinates."""
    dets = dets.copy()
    ratio = min(letterbox_shape[0] / ori_shape[0], letterbox_shape[1] / ori_shape[1])
    pad_w = (letterbox_shape[1] - ori_shape[1] * ratio) / 2
    pad_h = (letterbox_shape[0] - ori_shape[0] * ratio) / 2
    dets[:, 0:12:2] -= pad_w
    dets[:, 1:12:2] -= pad_h
    dets[:, :12] /= ratio
    dets[:, 0:12:2] = dets[:, 0:12:2].clip(0, ori_shape[1])
    dets[:, 1:12:2] = dets[:, 1:12:2].clip(0, ori_shape[0])
    return dets


class LoadData:
    """Iterate images and video frames from a file, glob, directory or webcam
    index. With decode_images=False still images come out as their encoded
    file bytes (for the native batch decoder, data/native.py); video frames
    are decoded either way."""

    def __init__(self, path: str, decode_images: bool = True):
        self._decode_images = decode_images
        if str(path).isdigit():  # webcam index
            self.img_files, self.vid_files = [], []
            self.files = [str(path)]
            self.webcam = int(path)
            return
        self.webcam = None
        p = str(os.path.abspath(path))
        if os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "**", "*.*"), recursive=True))
        elif os.path.isfile(p):
            files = [p]
        else:
            files = sorted(glob.glob(p, recursive=True))
        if not files:
            raise FileNotFoundError(f"Invalid source path: {path}")
        self.img_files = [f for f in files if f.split(".")[-1].lower() in IMG_FORMATS]
        self.vid_files = [f for f in files if f.split(".")[-1].lower() in VID_FORMATS]
        self.files = self.img_files + self.vid_files

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, str, str]]:
        """Yields (item, path, kind): kind 'image' (decoded BGR), 'video'
        (a decoded BGR frame) or, with decode_images=False, 'image_bytes'
        (the file's encoded bytes)."""
        if self.webcam is not None:
            import cv2

            yield from self._frames(cv2.VideoCapture(self.webcam), f"webcam{self.webcam}")
            return
        for f in self.img_files:
            if self._decode_images:
                import cv2

                img = cv2.imread(f)
                if img is not None:
                    yield img, f, "image"
            else:
                with open(f, "rb") as fh:
                    yield fh.read(), f, "image_bytes"
        for f in self.vid_files:
            import cv2

            yield from self._frames(cv2.VideoCapture(f), f)

    @staticmethod
    def _frames(cap, path):
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame, path, "video"
        finally:
            cap.release()
