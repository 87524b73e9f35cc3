"""Port parity: the device-resident dataset cache (data/device_cache.py),
mirroring tests/test_device_cache.py where one device applies.

The memo equals the JAX package's arrays and the per-item loader; the index
matrices are the JAX package's (a pure function of (seed, epoch)); the
gathered step equals the plain step on the same batch, an epoch the same
steps applied one by one, several epochs the epochs one by one (bit for
bit: the same device, the same operations); a dataset regenerated in place
gets a new memo.
"""

import os.path as osp
import time

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from yololp_tpu.data import device_cache as jdc
from yololp_tpu.data.datasets import TrainValDataset as JDataset
from yololp_tpu.data.synthetic import make_synthetic_dataset
from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
from yololp_tpu_torch.data import device_cache as tdc
from yololp_tpu_torch.data.datasets import TrainValDataset
from yololp_tpu_torch.losses.loss import LossConfig
from yololp_tpu_torch.models.yolo import build_model
from yololp_tpu_torch.solver.build import SolverConfig
from yololp_tpu_torch.utils.config import Config

torch.set_num_threads(4)

IMG = 64


def _dataset(root, n=6, seed=0):
    make_synthetic_dataset(str(root), n_train=n, n_val=2, img_size=IMG, seed=seed)
    return TrainValDataset(osp.join(str(root), "images", "train"), img_size=IMG, augment=False,
                           task="train")


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("cache") / "synth")


def new_step(batch_size=2):
    model = build_model(Config.named("yololpn"), seed=0, device="cpu")
    step = make_train_step(model, LossConfig(img_size=(IMG, IMG), iou_type="siou"),
                           SolverConfig(lr0=0.02, epochs=2, steps_per_epoch=2), batch_size)
    return init_train_state(model), step


def params(state):
    return [p.detach().clone() for p in state.params + state.batch_stats + state.ema_params]


def test_precompute_equals_jax_and_items_and_memoizes(ds):
    imgs, labels, masks = tdc.precompute_items(ds, verbose=False)
    assert imgs.shape == (len(ds), IMG, IMG, 3) and imgs.dtype == np.uint8
    for i in (0, len(ds) - 1):
        rgb, lbl, msk, _, _ = ds[i]
        np.testing.assert_array_equal(imgs[i], rgb)
        np.testing.assert_array_equal(labels[i], lbl)
        np.testing.assert_array_equal(masks[i], msk)
    imgs2, labels2, _ = tdc.precompute_items(ds, verbose=False)
    assert isinstance(imgs2, np.memmap)  # the memo was hit
    np.testing.assert_array_equal(np.asarray(imgs2), np.asarray(imgs))
    np.testing.assert_array_equal(labels2, labels)
    # the JAX package reads the same memo files and gets the same arrays
    jds = JDataset(ds.img_dir, img_size=IMG, augment=False, task="train")
    assert jdc._cache_paths(ds.img_dir, IMG, len(ds), ds.max_boxes, jdc._content_fingerprint(jds)) \
        == tdc.memo_paths(ds)
    for a, b in zip(jdc.precompute_items(jds, verbose=False), (imgs, labels, masks)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_index_matrices_equal_jax(ds):
    jcache = jdc.DeviceCachedData(JDataset(ds.img_dir, img_size=IMG, augment=False), seed=1)
    cache = tdc.DeviceCachedData(ds, seed=1, device="cpu")
    assert cache.images.shape == (len(ds), IMG * IMG * 3)  # flat staging layout
    for bs in (2, 4):
        assert cache.steps_per_epoch(bs) == jcache.steps_per_epoch(bs) == len(ds) // bs
        for epoch in range(3):
            np.testing.assert_array_equal(cache.epoch_index_matrix(bs, epoch),
                                          jcache.epoch_index_matrix(bs, epoch))
            for a, b in zip(cache.epoch_batches(bs, epoch), jcache.epoch_batches(bs, epoch)):
                np.testing.assert_array_equal(a, b)
    seen = np.concatenate(list(cache.epoch_batches(2, 0)))
    assert sorted(seen.tolist()) == list(range(len(ds)))


def test_cached_step_and_epoch_equal_plain_steps(ds):
    cache = tdc.DeviceCachedData(ds, seed=0, device="cpu")
    idx_mat = np.asarray([[2, 0], [1, 3]], np.int32)

    state, step = new_step()
    s1, total1, items1 = tdc.make_cached_step(step, cache.img_shape)(
        state, cache.images, cache.labels, cache.masks, torch.from_numpy(idx_mat[0]))
    p1 = params(s1)
    state, step = new_step()
    s2, total2, items2 = step(state, cache.host_images[idx_mat[0]],
                              cache.host_labels[idx_mat[0]], cache.host_masks[idx_mat[0]])
    assert torch.equal(total1, total2) and torch.equal(items1, items2)
    assert all(torch.equal(a, b) for a, b in zip(p1, params(s2)))

    # an epoch == the same steps one by one, the loss items summed
    state, step = new_step()
    se, items_sum = tdc.make_cached_epoch(step, cache.img_shape)(
        state, cache.images, cache.labels, cache.masks, torch.from_numpy(idx_mat))
    pe = params(se)
    assert se.step == 2
    state, step = new_step()
    cached = tdc.make_cached_step(step, cache.img_shape)
    acc = None
    for row in idx_mat:
        state, _, items = cached(state, cache.images, cache.labels, cache.masks, row)
        acc = items if acc is None else acc + items
    assert torch.equal(items_sum, acc)
    assert all(torch.equal(a, b) for a, b in zip(pe, params(state)))


def test_multi_epoch_equals_sequential_epochs(ds):
    cache = tdc.DeviceCachedData(ds, seed=0, device="cpu")
    mats = np.stack([cache.epoch_index_matrix(2, e) for e in range(2)])
    state, step = new_step()
    sm, items_multi = tdc.make_cached_multi_epoch(step, cache.img_shape)(
        state, cache.images, cache.labels, cache.masks, torch.from_numpy(mats))
    pm = params(sm)
    assert items_multi.shape == (2, 7) and sm.step == 2 * len(mats[0])
    state, step = new_step()
    epoch = tdc.make_cached_epoch(step, cache.img_shape)
    per = []
    for m in mats:
        state, items = epoch(state, cache.images, cache.labels, cache.masks, torch.from_numpy(m))
        per.append(items)
    assert torch.equal(items_multi, torch.stack(per))
    assert all(torch.equal(a, b) for a, b in zip(pm, params(state)))


def test_memo_invalidated_on_content_change(tmp_path):
    ds0 = _dataset(tmp_path / "synth", n=4, seed=0)
    imgs0 = np.asarray(tdc.precompute_items(ds0, verbose=False)[0]).copy()
    time.sleep(0.01)  # distinct mtimes
    ds1 = _dataset(tmp_path / "synth", n=4, seed=7)  # regenerated in place
    imgs1, _, _ = tdc.precompute_items(ds1, verbose=False)
    assert not np.array_equal(imgs0, np.asarray(imgs1))
    np.testing.assert_array_equal(np.asarray(imgs1[0]), ds1[0][0])
    # the previous generation's memos were removed
    assert sorted(p.name for p in (tmp_path / "synth" / "images" / "train").glob(".devcache_*")) \
        == sorted(osp.basename(p) for p in tdc.memo_paths(ds1).values())
