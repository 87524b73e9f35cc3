"""Dataset and loaders producing fixed-shape padded batches (copied from
yololp_tpu/data/datasets.py).

Batches are (images (B, H, W, 3) RGB uint8 NHWC, labels (B, MAX_BOXES, 20)
normalized, mask (B, MAX_BOXES), paths, shapes). On-disk labels are
`labels/<stem>.txt` beside `images/<stem>.*`, rows of 20 floats
`[pro, alp, ads0..5, cx, cy, w, h, x1..y4]`, coords normalized to [0, 1].

augment=True is the train protocol: mosaic, mixup, the plate generator's
warp and paste, random affine, HSV jitter (data/augment.py,
data/generate.py), drawn from Python's `random` and numpy's global state as
in the JAX package. cv2 is imported only where an image is read or
transformed, so the module imports on a machine without it.
`process_shard=(rank, world)` gives each rank of a process group its
strided slice of the dataset, padded by wrapping to one length on every
rank (the DistributedSampler's rule), so every rank runs the same steps.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import os.path as osp
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from yololp_tpu_torch.data.augment import augment_hsv, mixup, mosaic_augmentation, random_affine
from yololp_tpu_torch.data.generate import PlateGenerator, paste_plates, warp_into_image
from yololp_tpu_torch.data.images import IMG_FORMATS, letterbox

MAX_BOXES = 32


def img2label_path(img_path: str) -> str:
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def scan_dataset(img_dir: str, cache: bool = True) -> Tuple[List[str], List[np.ndarray]]:
    """Enumerate images, parse and validate their labels; cache them in a
    json keyed by an md5 of the paths and the label files' size and mtime."""
    img_paths = sorted(
        p for p in glob.glob(osp.join(img_dir, "**", "*.*"), recursive=True)
        if p.rsplit(".", 1)[-1].lower() in IMG_FORMATS)
    if not img_paths:
        raise FileNotFoundError(f"no images found in {img_dir}")

    cache_path = osp.join(img_dir, ".yololp_tpu_cache.json")

    def _lbl_stamp(p: str) -> str:
        try:
            st = os.stat(img2label_path(p))
            return f"{st.st_size}:{st.st_mtime_ns}"
        except OSError:
            return "-"
    key = hashlib.md5(
        "".join(f"{p}|{_lbl_stamp(p)};" for p in img_paths).encode()).hexdigest()
    if cache and osp.isfile(cache_path):
        try:
            with open(cache_path) as f:
                data = json.load(f)
            if data.get("hash") == key:
                return img_paths, [np.asarray(lbl, np.float32).reshape(-1, 20)
                                   for lbl in data["labels"]]
        except (json.JSONDecodeError, KeyError):
            pass

    labels = []
    for p in img_paths:
        lp = img2label_path(p)
        rows = np.zeros((0, 20), np.float32)
        if osp.isfile(lp):
            with open(lp) as f:
                vals = [x.split() for x in f.read().strip().splitlines() if x]
            if vals:
                rows = np.asarray(vals, np.float32)
                assert rows.shape[1] == 20, f"{lp}: wrong label format"
                assert (rows >= 0).all(), f"{lp}: labels must be >= 0"
                assert (rows[:, 8:] <= 1).all(), f"{lp}: coords must be normalized"
                rows = np.unique(rows, axis=0)
        labels.append(rows)
    if cache:
        try:
            with open(cache_path, "w") as f:
                json.dump({"hash": key, "labels": [lbl.tolist() for lbl in labels]}, f)
        except OSError:
            pass
    return img_paths, labels


class TrainValDataset:
    """Map-style dataset; __getitem__ returns (img RGB uint8 (H, W, 3),
    labels (MAX_BOXES, 20) normalized, mask (MAX_BOXES,), path, shapes)."""

    def __init__(self, img_dir: str, img_size: int = 640, augment: bool = False,
                 hyp: Optional[Dict] = None, task: str = "train",
                 max_boxes: int = MAX_BOXES, seed: Optional[int] = None,
                 cjk_font_path: Optional[str] = None,
                 process_shard: Optional[Tuple[int, int]] = None):
        self.img_dir = img_dir
        self.img_size = img_size
        self.augment = augment
        self.hyp = dict(hyp or {})
        self.task = task
        self.max_boxes = max_boxes
        self.img_paths, self.labels = scan_dataset(img_dir)
        if process_shard is not None:
            # unequal shards would give the ranks different steps an epoch,
            # and a rank would wait in a collective the others never join
            rank, world = process_shard
            n = len(self.img_paths)
            idxs = [(rank + i * world) % n for i in range(-(-n // world))]
            self.img_paths = [self.img_paths[i] for i in idxs]
            self.labels = [self.labels[i] for i in idxs]
        self.gen = PlateGenerator(seed=seed, cjk_font_path=cjk_font_path)

    def __len__(self):
        return len(self.img_paths)

    def disable_heavy_aug(self):
        """--stop_aug_last_n_epoch: mosaic and mixup off."""
        self.hyp["mosaic"] = 0.0
        self.hyp["mixup"] = 0.0

    def load_image(self, index, force_load_size=None):
        """cv2 read + ratio-preserving resize of the long side to img_size."""
        import cv2

        path = self.img_paths[index]
        im = cv2.imread(path)
        assert im is not None, f"Image Not Found {path}"
        h0, w0 = im.shape[:2]
        r = (force_load_size or self.img_size) / max(h0, w0)
        if r != 1:
            interp = cv2.INTER_AREA if r < 1 and not self.augment else cv2.INTER_LINEAR
            im = cv2.resize(im, (int(w0 * r), int(h0 * r)), interpolation=interp)
        return im, (h0, w0), im.shape[:2]

    def get_mosaic(self, index):
        indices = [index] + random.choices(range(len(self.img_paths)), k=3)
        random.shuffle(indices)
        imgs, hs, ws, labels = [], [], [], []
        for i in indices:
            img, _, (h, w) = self.load_image(i)
            imgs.append(img)
            hs.append(h)
            ws.append(w)
            labels.append(self.labels[i])
        return mosaic_augmentation(self.img_size, imgs, hs, ws, labels, self.hyp)

    def _pad(self, labels: np.ndarray):
        out = np.zeros((self.max_boxes, 20), np.float32)
        out[:, :8] = -1
        mask = np.zeros((self.max_boxes,), np.float32)
        n = min(len(labels), self.max_boxes)
        if n:
            out[:n] = labels[:n]
            mask[:n] = 1
        return out, mask

    def _letterboxed_item(self, index, new_shape):
        """Load + letterbox to new_shape (int or (h, w)) with box and corner
        bookkeeping; returns (img BGR, labels in pixels, shapes)."""
        hyp = self.hyp
        img, (h0, w0), (h, w) = self.load_image(index, hyp.get("test_load_size"))
        img, ratio, pad = letterbox(img, new_shape, auto=False, scaleup=self.augment,
                                    return_int=bool(hyp.get("letterbox_return_int")))
        shapes = (h0, w0), ((h * ratio / h0, w * ratio / w0), pad)

        labels = self.labels[index].copy()
        if labels.size:
            w_r, h_r = w * ratio, h * ratio
            out = labels.copy()
            out[:, 8] = w_r * (labels[:, 8] - labels[:, 10] / 2) + pad[0]
            out[:, 9] = h_r * (labels[:, 9] - labels[:, 11] / 2) + pad[1]
            out[:, 10] = w_r * (labels[:, 8] + labels[:, 10] / 2) + pad[0]
            out[:, 11] = h_r * (labels[:, 9] + labels[:, 11] / 2) + pad[1]
            out[:, 12:20:2] = w_r * labels[:, 12:20:2] + pad[0]
            out[:, 13:20:2] = h_r * labels[:, 13:20:2] + pad[1]
            labels = out
        return img, labels, shapes

    def _normalize_and_pad(self, img, labels):
        """Pixel labels -> normalized cxcywh + corners, padded to max_boxes,
        and BGR -> RGB."""
        if len(labels):
            h, w = img.shape[:2]
            labels[:, [8, 10]] = labels[:, [8, 10]].clip(0, w - 1e-3)
            labels[:, [9, 11]] = labels[:, [9, 11]].clip(0, h - 1e-3)
            labels[:, 12:20:2] = labels[:, 12:20:2].clip(0, w - 1e-3)
            labels[:, 13:20:2] = labels[:, 13:20:2].clip(0, h - 1e-3)
            boxes = labels[:, 8:12].copy()
            out = labels.copy()
            out[:, 8] = ((boxes[:, 0] + boxes[:, 2]) / 2) / w
            out[:, 9] = ((boxes[:, 1] + boxes[:, 3]) / 2) / h
            out[:, 10] = (boxes[:, 2] - boxes[:, 0]) / w
            out[:, 11] = (boxes[:, 3] - boxes[:, 1]) / h
            out[:, 12:20:2] = labels[:, 12:20:2] / w
            out[:, 13:20:2] = labels[:, 13:20:2] / h
            labels = out
        padded, mask = self._pad(labels if len(labels) else np.zeros((0, 20), np.float32))
        rgb = np.ascontiguousarray(img[..., ::-1])
        return rgb, padded, mask

    def get_rect(self, index, shape_hw):
        """One rect-val item letterboxed to the batch shape."""
        img, labels, shapes = self._letterboxed_item(index, tuple(shape_hw))
        rgb, padded, mask = self._normalize_and_pad(img, labels)
        return rgb, padded, mask, self.img_paths[index], shapes

    def image_shape(self, index):
        """(h0, w0) without decoding pixels (PIL header read; cv2 fallback)."""
        try:
            from PIL import Image

            with Image.open(self.img_paths[index]) as im:
                return im.size[1], im.size[0]
        except Exception:  # noqa: BLE001
            import cv2

            return cv2.imread(self.img_paths[index]).shape[:2]

    def __getitem__(self, index):
        hyp = self.hyp
        if self.augment and random.random() < hyp.get("mosaic", 0):
            img, labels = self.get_mosaic(index)
            shapes = None
            if random.random() < hyp.get("mixup", 0):
                img2, labels2 = self.get_mosaic(random.randint(0, len(self.img_paths) - 1))
                img, labels = mixup(img, labels, img2, labels2)
            if random.random() < hyp.get("generate", 0):
                img, labels = warp_into_image(img, labels, self.gen)
            if random.random() < hyp.get("gen_paste", 0):
                img, labels = paste_plates(img, labels, self.gen)
        else:
            img, labels, shapes = self._letterboxed_item(index, self.img_size)
            if self.augment and random.random() < hyp.get("generate", 0):
                img, labels = warp_into_image(img, labels, self.gen)
            if self.augment:
                img, labels = random_affine(
                    img, labels, degrees=hyp.get("degrees", 0),
                    translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.5),
                    shear=hyp.get("shear", 0), new_shape=(self.img_size, self.img_size))
        if self.augment:
            augment_hsv(img, hgain=hyp.get("hsv_h", 0.015), sgain=hyp.get("hsv_s", 0.7),
                        vgain=hyp.get("hsv_v", 0.4))
        rgb, padded, mask = self._normalize_and_pad(img, labels)
        return rgb, padded, mask, self.img_paths[index], shapes


def collate_batch(samples):
    imgs, labels, masks, paths, shapes = zip(*samples)
    return (np.stack(imgs), np.stack(labels), np.stack(masks), list(paths), list(shapes))


class _Loader:
    """Single-process loader."""

    def __init__(self, dataset, batch_size, shuffle, drop_last):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            random.shuffle(idxs)
        batch = []
        for i in idxs:
            batch.append(self.dataset[i])
            if len(batch) == self.batch_size:
                yield collate_batch(batch)
                batch = []
        if batch and not self.drop_last:
            yield collate_batch(batch)


class NativeValLoader:
    """Square-letterbox val loader on the native batch decoder
    (data/native.py): one decode + letterbox call a batch, the labels mapped
    by vectorized numpy from the (ratio, pad) it returns. The plain val
    protocol only (no augment, test_load_size or letterbox_return_int)."""

    def __init__(self, dataset: TrainValDataset, batch_size: int, img_size: int):
        self.ds = dataset
        self.bs = batch_size
        self.img_size = img_size

    def __len__(self):
        return -(-len(self.ds) // self.bs)

    def __iter__(self):
        from yololp_tpu_torch.data.native import decode_letterbox_batch

        size = self.img_size
        n = len(self.ds)
        for b0 in range(0, n, self.bs):
            idxs = range(b0, min(b0 + self.bs, n))
            paths = [self.ds.img_paths[i] for i in idxs]
            bufs = []
            for p in paths:
                with open(p, "rb") as f:
                    bufs.append(f.read())
            # scaleup=True is the val protocol: the per-image path resizes the
            # long side to img_size (up or down) before its letterbox
            # (scaleup=False), so the combined ratio is the uncapped one
            imgs, ratios, pads_w, pads_h = decode_letterbox_batch(bufs, size, scaleup=True)
            labels, masks, shapes = [], [], []
            for j, i in enumerate(idxs):
                r, pw, ph = float(ratios[j]), float(pads_w[j]), float(pads_h[j])
                w_r, h_r = size - 2 * pw, size - 2 * ph  # content extent
                lbl = self.ds.labels[i]
                out = np.zeros((self.ds.max_boxes, 20), np.float32)
                out[:, :8] = -1
                mask = np.zeros((self.ds.max_boxes,), np.float32)
                m = min(len(lbl), self.ds.max_boxes)
                if m:
                    l = lbl[:m]
                    px = np.empty((m, 20), np.float32)
                    px[:, :8] = l[:, :8]
                    px[:, 8] = w_r * (l[:, 8] - l[:, 10] / 2) + pw
                    px[:, 9] = h_r * (l[:, 9] - l[:, 11] / 2) + ph
                    px[:, 10] = w_r * (l[:, 8] + l[:, 10] / 2) + pw
                    px[:, 11] = h_r * (l[:, 9] + l[:, 11] / 2) + ph
                    px[:, 12:20:2] = w_r * l[:, 12:20:2] + pw
                    px[:, 13:20:2] = h_r * l[:, 13:20:2] + ph
                    # back to the normalized batch format (cxcywh and corners
                    # over img_size, as _normalize_and_pad gives them)
                    out[:m, :8] = l[:, :8]
                    out[:m, 8] = (px[:, 8] + px[:, 10]) / 2 / size
                    out[:m, 9] = (px[:, 9] + px[:, 11]) / 2 / size
                    out[:m, 10] = (px[:, 10] - px[:, 8]) / size
                    out[:m, 11] = (px[:, 11] - px[:, 9]) / size
                    out[:m, 12:20:2] = px[:, 12:20:2] / size
                    out[:m, 13:20:2] = px[:, 13:20:2] / size
                    mask[:m] = 1
                h0 = int(round(h_r / r)) if r > 0 else size
                w0 = int(round(w_r / r)) if r > 0 else size
                labels.append(out)
                masks.append(mask)
                shapes.append(((h0, w0), ((r, r), (pw, ph))))
            yield (imgs, np.stack(labels), np.stack(masks), paths, shapes)


class RectValLoader:
    """Rect-batched validation (--rect): aspect-sorted batches letterboxed to
    per-batch shapes with pad-0.5 stride rounding, the shapes rounded up to
    multiples of `quantum` (the JAX package's bounded set of shapes)."""

    def __init__(self, dataset: TrainValDataset, batch_size: int, img_size: int,
                 stride: int = 32, pad: float = 0.5, quantum: int = 64):
        self.ds = dataset
        self.bs = batch_size
        n = len(dataset)
        shapes = np.array([dataset.image_shape(i) for i in range(n)], np.float64)  # (n, 2) h, w
        ar = shapes[:, 0] / shapes[:, 1]
        self.order = np.argsort(ar)
        self.batch_shapes = []
        self.batches = []
        for b0 in range(0, n, batch_size):
            idxs = self.order[b0:b0 + batch_size]
            ari = ar[idxs]
            mini, maxi = float(ari.min()), float(ari.max())
            shape = [1.0, 1.0]
            if maxi < 1:
                shape = [maxi, 1.0]
            elif mini > 1:
                shape = [1.0, 1.0 / mini]
            hw = np.ceil(np.array(shape) * img_size / stride + pad) * stride
            hw = (np.ceil(hw / quantum) * quantum).astype(int)
            self.batches.append(idxs)
            self.batch_shapes.append((int(hw[0]), int(hw[1])))

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for idxs, shape in zip(self.batches, self.batch_shapes):
            yield collate_batch([self.ds.get_rect(i, shape) for i in idxs])


def create_dataloader(path, img_size, batch_size, hyp=None, augment=False, workers=8,
                      shuffle=None, drop_last=None, task="train", max_boxes: int = MAX_BOXES,
                      seed=None, process_shard=None):
    """The host pipeline: torch.utils.data.DataLoader with `workers` spawned
    processes, or the single-process loader with workers=0. Training drops
    the last partial batch, so every step has one shape. `batch_size` is
    this process's; process_shard=(rank, world) loads the rank's slice."""
    if shuffle is None:
        shuffle = task == "train"
    if drop_last is None:
        drop_last = task == "train"
    dataset = TrainValDataset(path, img_size=img_size, augment=augment, hyp=hyp, task=task,
                              max_boxes=max_boxes, seed=seed, process_shard=process_shard)
    if workers > 0:
        from torch.utils.data import DataLoader

        loader = DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, num_workers=workers,
                            collate_fn=collate_batch, drop_last=drop_last,
                            persistent_workers=True, multiprocessing_context="spawn",
                            prefetch_factor=2)
        return loader, dataset
    return _Loader(dataset, batch_size, shuffle, drop_last), dataset
