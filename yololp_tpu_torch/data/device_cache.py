"""Device-resident dataset cache: train batches gathered on the device by
index (mirrors yololp_tpu/data/device_cache.py).

The whole dataset (uint8 images, padded labels and masks) is staged on the
device once; each step gathers its batch there by a (B,) index vector, so a
step moves no image over PCIe. The host preprocessing (decode, letterbox,
label normalization: the val protocol of data/datasets.py) runs once and is
memoized on disk next to the images as .npy files keyed by size, count and
a content fingerprint (file names, sizes, mtimes and the parsed labels), so
a dataset regenerated in place never serves stale arrays. A run whose memos
exist reads only them (and stats the image files): no image is decoded.

Only valid for the deterministic no-augmentation protocol; the Trainer
requires every augmentation off before it takes this path.

The JAX package scans the train step over an epoch's (S, B) index matrix in
one XLA program; here the epoch is an eager loop over the matrix's rows with
the loss items summed on the device, and nothing is read back to the host
inside an epoch. In a process group every rank stages the whole dataset on
its card and computes the same global matrix (a function of the seed and
the epoch); each rank gathers its block of every row.
"""

from __future__ import annotations

import glob
import hashlib
import os
import os.path as osp
from typing import Tuple

import numpy as np
import torch

from yololp_tpu_torch.utils.device import resolve_device


def _content_fingerprint(dataset) -> str:
    """Per image file (name, size, mtime) plus the parsed labels, md5'd."""
    h = hashlib.md5()
    for p in dataset.img_paths:
        st = os.stat(p)
        h.update(f"{osp.basename(p)}:{st.st_size}:{st.st_mtime_ns}".encode())
    for lbl in dataset.labels:
        h.update(np.ascontiguousarray(lbl, np.float32).tobytes())
    return h.hexdigest()[:12]


def _cache_paths(img_dir: str, img_size: int, n: int, max_boxes: int, fingerprint: str = ""):
    tag = f"devcache_{img_size}_{n}_{max_boxes}"
    if fingerprint:
        tag += f"_{fingerprint}"
    return {k: osp.join(img_dir, f".{tag}.{k}.npy") for k in ("images", "labels", "masks")}


def memo_paths(dataset):
    """The .npy memo paths precompute_items reads and writes for `dataset`."""
    return _cache_paths(dataset.img_dir, dataset.img_size, len(dataset), dataset.max_boxes,
                        _content_fingerprint(dataset))


def precompute_items(dataset, verbose: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The val-protocol item of every image (letterbox, normalize, pad):
    (N, S, S, 3) uint8, (N, M, 20) f32, (N, M) f32 on the host, memoized on
    disk."""
    if dataset.augment:
        raise ValueError("the device cache requires augment=False")
    n, s, m = len(dataset), dataset.img_size, dataset.max_boxes
    paths = memo_paths(dataset)
    if all(osp.isfile(p) for p in paths.values()):
        return (np.load(paths["images"], mmap_mode="r"), np.load(paths["labels"]),
                np.load(paths["masks"]))

    # a regenerated dataset has a new fingerprint: drop the old memos of this shape
    stale = set(glob.glob(osp.join(dataset.img_dir, f".devcache_{s}_{n}_{m}_*.npy")))
    for p in stale - set(paths.values()):
        try:
            os.remove(p)
        except OSError:
            pass

    # pid-unique temporaries and atomic renames: concurrent precomputes write
    # the same content, the last rename wins
    tmp = f".tmp.{os.getpid()}"
    images = np.lib.format.open_memmap(paths["images"] + tmp, mode="w+", dtype=np.uint8,
                                       shape=(n, s, s, 3))
    labels = np.empty((n, m, 20), np.float32)
    masks = np.empty((n, m), np.float32)
    for i in range(n):
        rgb, lbl, msk, _path, _shapes = dataset[i]
        images[i] = rgb
        labels[i] = lbl
        masks[i] = msk
        if verbose and (i + 1) % 2000 == 0:
            print(f"device-cache precompute: {i + 1}/{n}", flush=True)
    images.flush()
    np.save(paths["labels"] + tmp, labels)
    np.save(paths["masks"] + tmp, masks)
    for k in ("labels", "masks"):
        os.replace(paths[k] + tmp + ".npy", paths[k])
    os.replace(paths["images"] + tmp, paths["images"])
    return np.load(paths["images"], mmap_mode="r"), labels, masks


class DeviceCachedData:
    """The dataset staged on `device`: images flat (N, H*W*3) uint8, labels
    (N, M, 20), masks (N, M). `host_images` (a memmap) stays for drawing."""

    def __init__(self, dataset, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        self.host_images, self.host_labels, self.host_masks = precompute_items(dataset)
        self.n = len(self.host_images)
        self.img_shape = tuple(self.host_images.shape[1:])  # (H, W, 3)
        flat = self.host_images.reshape(self.n, -1)
        self.images = torch.empty(flat.shape, dtype=torch.uint8, device=dev)
        for i in range(0, self.n, 1024):  # chunks of the (read-only) memmap
            self.images[i:i + 1024].copy_(torch.from_numpy(np.array(flat[i:i + 1024])))
        self.labels = torch.from_numpy(np.asarray(self.host_labels)).to(dev)
        self.masks = torch.from_numpy(np.asarray(self.host_masks)).to(dev)
        self.seed = seed

    def _perm(self, epoch: int) -> np.ndarray:
        # a pure function of (seed, epoch): a resumed run sees epoch k's order
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)

    def epoch_batches(self, batch_size: int, epoch: int = 0):
        """(B,) int32 index arrays, one a step; the tail is dropped."""
        perm = self._perm(epoch)
        for b0 in range(0, self.n - batch_size + 1, batch_size):
            yield perm[b0:b0 + batch_size].astype(np.int32)

    def epoch_index_matrix(self, batch_size: int, epoch: int = 0) -> np.ndarray:
        """One epoch's shuffled batch indices as an (S, B) int32 matrix."""
        s = self.steps_per_epoch(batch_size)
        return self._perm(epoch)[: s * batch_size].reshape(s, batch_size).astype(np.int32)

    def steps_per_epoch(self, batch_size: int) -> int:
        return self.n // batch_size


def make_cached_step(step_fn, img_shape, shard=None):
    """cached_step(state, images_all, labels_all, masks_all, idxs): the batch
    gathered on the device from the flat (N, H*W*3) staging layout, then
    `step_fn`. shard=(rank, world): `idxs` is the global batch's row and
    this rank gathers its contiguous block of it (the JAX package shards the
    gathered batch over 'data' in the same blocks)."""
    def cached_step(state, images_all, labels_all, masks_all, idxs):
        idxs = torch.as_tensor(idxs).to(images_all.device, torch.long)
        if shard is not None:
            r, w = shard
            hb = idxs.shape[0] // w
            idxs = idxs[r * hb:(r + 1) * hb]
        images = images_all.index_select(0, idxs).reshape((idxs.shape[0],) + tuple(img_shape))
        return step_fn(state, images, labels_all.index_select(0, idxs),
                       masks_all.index_select(0, idxs))

    return cached_step


def make_cached_epoch(step_fn, img_shape, shard=None):
    """epoch_fn(state, images_all, labels_all, masks_all, idx_mat) -> (state,
    loss items summed over the epoch's steps, on the device). `idx_mat` is
    the global (S, B) matrix; `shard` as in make_cached_step."""
    cached_step = make_cached_step(step_fn, img_shape, shard)

    def epoch_fn(state, images_all, labels_all, masks_all, idx_mat):
        idx_mat = torch.as_tensor(idx_mat).to(images_all.device, torch.long)
        items_sum = None
        for row in idx_mat:
            state, _total, items = cached_step(state, images_all, labels_all, masks_all, row)
            items_sum = items if items_sum is None else items_sum + items
        return state, items_sum

    return epoch_fn


def make_cached_multi_epoch(step_fn, img_shape, shard=None):
    """K consecutive epochs over a (K, S, B) index tensor: multi_epoch_fn(
    state, images_all, labels_all, masks_all, idx_mats) -> (state, (K, n)
    per-epoch loss-item sums). The same steps as K make_cached_epoch calls
    (the schedules depend on the step count alone)."""
    epoch_fn = make_cached_epoch(step_fn, img_shape, shard)

    def multi_epoch_fn(state, images_all, labels_all, masks_all, idx_mats):
        sums = []
        for idx_mat in torch.as_tensor(idx_mats):
            state, items = epoch_fn(state, images_all, labels_all, masks_all, idx_mat)
            sums.append(items)
        return state, torch.stack(sums)

    return multi_epoch_fn
