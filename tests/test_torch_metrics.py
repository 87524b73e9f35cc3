"""Port parity: utils/metrics.py (compute_ap, ap_per_class, ConfusionMatrix,
character_confusions) against yololp_tpu/utils/metrics.py on the same
seeded inputs, built as tests/test_metrics.py builds them. Both are numpy
with one operation order, so the results must be equal."""

import numpy as np
import pytest

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.utils import metrics as jmetrics
from yololp_tpu_torch.utils import metrics


def random_tp(rng, n=200, n_iou=10, ncls=5, m=150):
    tp = (rng.uniform(0, 1, (n, n_iou)) > 0.5).astype(np.float64)
    conf = rng.uniform(0, 1, n)
    pred_cls = rng.integers(0, ncls, n).astype(float)
    target_cls = rng.integers(0, ncls, m).astype(float)
    return tp, conf, pred_cls, target_cls


@pytest.mark.parametrize("seed", [33, 34])
def test_compute_ap_and_ap_per_class_equal_jax(seed):
    rng = np.random.default_rng(seed)
    args = random_tp(rng)
    got, want = metrics.ap_per_class(*args), jmetrics.ap_per_class(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[4].dtype == want[4].dtype == np.int32
    rec = np.sort(rng.uniform(0, 1, 50))
    pre = rng.uniform(0, 1, 50)
    for g, w in zip(metrics.compute_ap(rec, pre), jmetrics.compute_ap(rec, pre)):
        np.testing.assert_array_equal(g, w)


def test_ap_per_class_plots(tmp_path):
    pytest.importorskip("matplotlib")
    args = random_tp(np.random.default_rng(1), n=60, ncls=3, m=40)
    got = metrics.ap_per_class(*args, plot=True, save_dir=str(tmp_path), names=["a", "b", "c"])
    want = jmetrics.ap_per_class(*args)
    np.testing.assert_array_equal(got[2], want[2])
    for name in ("PR_curve", "F1_curve", "P_curve", "R_curve"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0


def random_boxes(rng, n, scale=300.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(10, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def test_confusion_matrix_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    cm, jcm = metrics.ConfusionMatrix(nc=4), jmetrics.ConfusionMatrix(nc=4)
    for _ in range(12):
        n_lbl, n_det = int(rng.integers(0, 6)), int(rng.integers(0, 8))
        labels = np.concatenate([rng.integers(0, 4, (n_lbl, 1)), random_boxes(rng, n_lbl)], 1)
        # half of the detections jitter a label's box, so some match
        boxes = random_boxes(rng, n_det)
        k = min(n_lbl, n_det // 2)
        boxes[:k] = labels[:k, 1:5] + rng.normal(0, 4, (k, 4))
        dets = np.concatenate([boxes, rng.uniform(0, 1, (n_det, 1)),
                               rng.integers(0, 4, (n_det, 1))], 1).astype(np.float32)
        cm.process_batch(dets, labels.astype(np.float32))
        jcm.process_batch(dets, labels.astype(np.float32))
    np.testing.assert_array_equal(cm.matrix, jcm.matrix)
    assert cm.matrix[:4, :4].trace() > 0 and cm.matrix[4].sum() > 0 and cm.matrix[:, 4].sum() > 0
    pytest.importorskip("matplotlib")
    cm.plot(str(tmp_path), names=["a", "b", "c", "d"])
    assert (tmp_path / "confusion_matrix.png").stat().st_size > 0


def test_confusion_matrix_counts():
    """tests/test_metrics.py's hand-counted case."""
    cm = metrics.ConfusionMatrix(nc=3, conf=0.25, iou_thres=0.45)
    dets = np.array([[10, 10, 50, 50, 0.9, 1], [100, 100, 150, 150, 0.8, 2],
                     [10, 10, 50, 50, 0.1, 0]], np.float32)
    labels = np.array([[1, 12, 12, 52, 52], [0, 300, 300, 340, 340]], np.float32)
    cm.process_batch(dets, labels)
    assert cm.matrix[1, 1] == 1 and cm.matrix[2, 3] == 1 and cm.matrix[3, 0] == 1


def lp_preds_targets(rng, n_img=10):
    """Evaler.predict's layout: (n, 28) detections, (m, 20) targets in
    pixels; detections near their targets with some characters wrong, one
    of them out of vocabulary."""
    preds, targets = [], []
    for i in range(n_img):
        m = int(rng.integers(0, 4))
        box = random_boxes(rng, m)
        cls = np.concatenate([rng.integers(0, 31, (m, 1)), rng.integers(0, 24, (m, 1)),
                              rng.integers(0, 37, (m, 6))], 1)
        cors = rng.uniform(0, 300, (m, 8))
        targets.append(np.concatenate([cls, box, cors], 1).astype(np.float32))
        n = m + int(rng.integers(0, 3)) if i % 4 else 0
        k = min(m, n)
        pbox = random_boxes(rng, n)
        pbox[:k] = box[:k] + rng.normal(0, 3, (k, 4))
        pcls = np.concatenate([rng.integers(0, 31, (n, 1)), rng.integers(0, 24, (n, 1)),
                               rng.integers(0, 37, (n, 6))], 1)
        keep = rng.uniform(0, 1, (k, 8)) < 0.7
        pcls[:k] = np.where(keep, cls[:k], pcls[:k])
        if n:
            pcls[0, 2] = 40  # out of vocabulary: counted in the last row
        preds.append(np.concatenate([pbox, rng.uniform(0, 300, (n, 8)), rng.uniform(0, 1, (n, 8)),
                                     pcls], 1).astype(np.float32))
    return preds, targets


@pytest.mark.parametrize("nads", [37, 35])
def test_character_confusions_equal_jax(nads):
    preds, targets = lp_preds_targets(np.random.default_rng(nads))
    got = metrics.character_confusions(preds, targets, nads=nads)
    want = jmetrics.character_confusions(preds, targets, nads=nads)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (32, 32) and got[2].shape == (nads + 1, nads + 1)
    assert sum(int(m.trace()) for m in got) > 0
    assert sum(int(m.sum() - m.trace()) for m in got) > 0
