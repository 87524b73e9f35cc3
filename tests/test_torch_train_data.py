"""Port parity: the train half of the data path (data/augment.py,
data/generate.py, data/glyphs.py, data/synthetic.py and datasets.py with
augment=True) and the drawing (utils/visualize.py, Inferer.draw) against
the JAX package's host code, element for element.

Both are numpy/cv2/PIL host code drawn from Python's `random` and numpy's
global state (the plate generator from its own seeded Generator): each case
seeds both states, runs the JAX function, seeds them again and runs the
port's, and requires equal arrays.
"""

import os.path as osp
import random
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401
from yololp_tpu.data import augment as ja
from yololp_tpu.data import datasets as jd
from yololp_tpu.data import generate as jg
from yololp_tpu.data.synthetic import make_synthetic_dataset as j_make
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.data import augment as ta
from yololp_tpu_torch.data import datasets as td
from yololp_tpu_torch.data import generate as tg
from yololp_tpu_torch.data.synthetic import make_synthetic_dataset as t_make

IMG = 64


def seeded(fn, seed, *args, **kw):
    random.seed(seed)
    np.random.seed(seed)
    return fn(*args, **kw)


def assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def labels_px(rng, n, w, h):
    """Pixel-coordinate label rows [cls(8), x1y1x2y2, corners(8)]."""
    out = np.zeros((n, 20), np.float32)
    out[:, :8] = rng.integers(0, 30, (n, 8))
    x1, y1 = rng.uniform(0, w * 0.6, n), rng.uniform(0, h * 0.6, n)
    x2, y2 = x1 + rng.uniform(8, w * 0.4, n), y1 + rng.uniform(4, h * 0.3, n)
    out[:, 8:12] = np.stack([x1, y1, x2, y2], 1)
    out[:, 12:20] = np.stack([x1, y1, x1, y2, x2, y2, x2, y1], 1)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    return {"root": root,
            "jax": j_make(str(root / "jax"), n_train=6, n_val=2, img_size=IMG, seed=3),
            "port": t_make(str(root / "port"), n_train=6, n_val=2, img_size=IMG, seed=3)}


def test_augment_functions_equal_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (96, 128, 3), np.uint8)
    img2 = rng.integers(0, 255, (96, 128, 3), np.uint8)
    lab, lab2 = labels_px(rng, 3, 128, 96), labels_px(rng, 2, 128, 96)
    for seed in range(3):
        a, b = img.copy(), img.copy()
        seeded(ja.augment_hsv, seed, a, 0.015, 0.7, 0.4)
        seeded(ta.augment_hsv, seed, b, 0.015, 0.7, 0.4)
        assert_same(a, b)
        assert_same(seeded(ja.mixup, seed, img, lab, img2, lab2),
                    seeded(ta.mixup, seed, img, lab, img2, lab2))
        kw = dict(degrees=20.0, translate=0.1, scale=0.5, shear=2.0, new_shape=(IMG, IMG))
        assert_same(seeded(ja.random_affine, seed, img, lab.copy(), **kw),
                    seeded(ta.random_affine, seed, img, lab.copy(), **kw))
        hyp = dict(degrees=20.0, translate=0.1, scale=0.5, shear=0.0)
        norm = [np.concatenate([lab[:, :8], np.tile([[0.5, 0.5, 0.3, 0.1]], (3, 1)),
                                np.tile([[0.35, 0.45, 0.35, 0.55, 0.65, 0.55, 0.65, 0.45]], (3, 1))],
                               1).astype(np.float32)] * 4
        imgs = [img, img2, img, img2]
        assert_same(seeded(ja.mosaic_augmentation, seed, IMG, imgs, [96] * 4, [128] * 4, norm, hyp),
                    seeded(ta.mosaic_augmentation, seed, IMG, imgs, [96] * 4, [128] * 4, norm, hyp))


def test_plate_generator_equals_jax():
    rng = np.random.default_rng(1)
    for seed, diversity in ((0, 0.0), (5, 0.6)):
        jgen = jg.PlateGenerator(seed=seed, diversity=diversity)
        tgen = tg.PlateGenerator(seed=seed, diversity=diversity)
        for style in (None, "blue", "green_s", "green_b", "yellow"):
            assert_same(jgen.generate(style), tgen.generate(style))
        img = rng.integers(0, 255, (IMG * 2, IMG * 2, 3), np.uint8)
        lab = labels_px(rng, 2, IMG * 2, IMG * 2)
        assert_same(seeded(jg.warp_into_image, seed, img.copy(), lab.copy(), jgen),
                    seeded(tg.warp_into_image, seed, img.copy(), lab.copy(), tgen))
        assert_same(seeded(jg.paste_plates, seed, img.copy(), lab.copy(), jgen),
                    seeded(tg.paste_plates, seed, img.copy(), lab.copy(), tgen))


def test_synthetic_dataset_equals_jax(data):
    import cv2

    for split in ("train", "val"):
        jdir, tdir = data["jax"][split], data["port"][split]
        names = sorted(p.name for p in Path(jdir).iterdir())
        assert names == sorted(p.name for p in Path(tdir).iterdir())
        assert len(names) == (6 if split == "train" else 2)
        for name in names:
            np.testing.assert_array_equal(cv2.imread(osp.join(tdir, name)),
                                          cv2.imread(osp.join(jdir, name)))
            stem = name.rsplit(".", 1)[0] + ".txt"
            lj = open(jd.img2label_path(osp.join(jdir, name))).read()
            lt = open(td.img2label_path(osp.join(tdir, name))).read()
            assert lt == lj and lt.strip(), stem


def test_augment_loader_batch_equals_jax(data):
    """A seeded augment=True batch (mosaic, generate, paste, affine, HSV)
    at 64 px through each package's single-process loader."""
    hyp = dict(JConfig.named("yololpn")["data_aug"])
    hyp["mixup"] = 0.5
    path = data["jax"]["train"]
    jl, jds = jd.create_dataloader(path, IMG, 3, hyp=hyp, augment=True, workers=0, seed=7)
    tl, tds = td.create_dataloader(path, IMG, 3, hyp=hyp, augment=True, workers=0, seed=7)
    assert len(jl) == len(tl) == 2
    for seed in (11, 12):
        jb = seeded(lambda: list(jl), seed)
        tb = seeded(lambda: list(tl), seed)
        for a, b in zip(jb, tb):
            assert_same(list(a[:4]), list(b[:4]))
            assert a[0].shape == (3, IMG, IMG, 3) and a[1].shape == (3, td.MAX_BOXES, 20)
    assert any(m.sum() > 0 for m in (b[2] for b in tb))
    jds.disable_heavy_aug()
    tds.disable_heavy_aug()
    assert tds.hyp == jds.hyp and tds.hyp["mosaic"] == 0.0


def test_drawing_equals_jax():
    """utils/visualize.py (copied) and Inferer.draw draw the same pixels as
    the JAX package's (boxes, corner quads, plate strings in the glyph
    renderer)."""
    import types

    from yololp_tpu.core.inferer import Inferer as JInferer
    from yololp_tpu.utils import visualize as jv
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.utils import visualize as tv

    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (96, 128, 3), np.uint8)
    dets = np.zeros((2, 28), np.float32)
    dets[:, :4] = [[10, 20, 70, 40], [60, 50, 120, 80]]
    dets[:, 4:12] = [[10, 20, 10, 40, 70, 40, 70, 20], [60, 50, 60, 80, 120, 80, 120, 50]]
    dets[:, 12:20] = rng.uniform(0.3, 0.9, (2, 8))
    dets[:, 20:28] = [[3, 5, 1, 2, 30, 31, 35, 36], [12, 0, 9, 8, 7, 6, 5, 4]]
    assert_same(tv.draw_detections(img, dets), jv.draw_detections(img, dets))
    labels = np.concatenate([dets[:, 20:28], [[0.3, 0.3, 0.4, 0.2], [0.7, 0.6, 0.3, 0.2]],
                             dets[:, 4:12] / 128.0], 1).astype(np.float32)
    assert_same(tv.draw_labels(img, labels), jv.draw_labels(img, labels))
    assert_same(tv.image_grid([img, img[::-1]], cols=2, cell=64),
                jv.image_grid([img, img[::-1]], cols=2, cell=64))
    fake = types.SimpleNamespace(plate_text=Inferer.plate_text)
    assert_same(Inferer.draw(fake, img, dets),
                JInferer.draw(types.SimpleNamespace(plate_text=JInferer.plate_text), img, dets))
