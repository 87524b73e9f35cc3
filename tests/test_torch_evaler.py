"""Port parity: the evaler, its data path and the eval CLI against
yololp_tpu.core.evaler on the CPU.

The LP metric is numpy in both packages: the same (preds, targets) give the
identical metric list. `predict` runs on a labelled set that the JAX package
writes in the test (`make_synthetic_dataset`, 64 px): the targets must be
identical; the detections equal within the fp32 decode tolerance of
tests/test_torch_inferer.py (rtol 1e-4, atol 1e-3 px / score) and with the
same counts and class ids, which needs every gate score and candidate IoU
clear of its threshold (checked for the chosen seed). yololpn, every
parameter randomized from a seed, fused, fp32.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_models import jax_variables
from yololp_tpu.core.evaler import Evaler as JEvaler
from yololp_tpu.utils import checkpoint as jckpt
from yololp_tpu_torch.core.evaler import Evaler, run_eval
from yololp_tpu_torch.ops.geometry import pairwise_iou, xywh2xyxy

torch.set_num_threads(2)

IMG = 64
KW = dict(batch_size=4, img_size=IMG, conf_thres=0.45, iou_thres=0.45, max_det=20)
SEED = 41
MARGIN = 1e-4


def random_preds_targets(rng, n_img=12):
    """Detections (n, 28) near the gts with random corners and characters,
    some images empty on either side, so every bucket and branch is hit."""
    preds, targets = [], []
    for i in range(n_img):
        m = int(rng.integers(0, 4)) if i % 5 else 0
        t = np.zeros((m, 20), np.float32)
        t[:, :8] = rng.integers(0, 5, (m, 8))
        xy = rng.uniform(0, 40, (m, 2))
        wh = rng.uniform(8, 24, (m, 2))
        t[:, 8:10], t[:, 10:12] = xy, xy + wh
        t[:, 12:20] = np.repeat(xy, 4, 0).reshape(m, 8) + rng.uniform(0, 8, (m, 8))
        n = 0 if i % 7 == 3 else m + int(rng.integers(0, 2))
        p = np.zeros((n, 28), np.float32)
        for j in range(n):
            if j < m:  # jitter a gt: IoU from ~0.3 to 1
                p[j, :4] = t[j, 8:12] + rng.normal(0, rng.choice([0.3, 2.0, 5.0]), 4)
                p[j, 4:12] = t[j, 12:20] + rng.normal(0, 1.0, 8)
                p[j, 20:28] = np.where(rng.random(8) < 0.9, t[j, :8], 4)
            else:
                p[j, :4] = [1, 1, 5, 5]
        p[:, 12:20] = rng.random((n, 8))
        preds.append(p)
        targets.append(t)
    return preds, targets


def test_metric_list_equals_jax():
    rng = np.random.default_rng(0)
    ev_t = Evaler({}, device="cpu")
    ev_j = JEvaler({})
    seen_empty_bucket = seen_full_bucket = False
    for _ in range(6):
        preds, targets = random_preds_targets(rng)
        got, want = ev_t.eval(preds, targets), ev_j.eval(preds, targets)
        assert got == want
        seen_empty_bucket |= -1 in want[5]
        seen_full_bucket |= any(0 < v <= 1 for v in want[5])
    assert seen_empty_bucket and seen_full_bucket
    assert ev_t.eval([], []) == ev_j.eval([], [])
    assert ev_t.eval([np.zeros((0, 28))], [np.zeros((2, 20))]) == \
        ev_j.eval([np.zeros((0, 28))], [np.zeros((2, 20))])


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from yololp_tpu.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("synth")
    make_synthetic_dataset(str(root), n_train=0, n_val=6, img_size=IMG, seed=3)
    ckpt = str(root / "yololpn.msgpack")
    jckpt.save_checkpoint({"format": "train", "step": 0,
                           "variables": jax_variables("yololpn", seed=SEED),
                           "ema": None, "opt_state": None, "meta": {}}, ckpt)
    return {"val": str(root / "images" / "val")}, ckpt, root


@pytest.fixture(scope="module")
def models(synthetic):
    import jax.numpy as jnp

    from yololp_tpu.models.yolo import Model as JModel
    from yololp_tpu.utils.config import Config as JConfig
    from yololp_tpu_torch.core.inferer import Inferer

    _, ckpt, _ = synthetic
    jvars = jckpt.load_inference_variables(ckpt)
    jmodel = JModel(JConfig.named("yololpn"), deploy=True, dtype=jnp.float32)
    inf = Inferer(None, ckpt, "yololpn", img_size=IMG, half=False, device="cpu")
    return jmodel, jvars, inf.model


def jax_predict(data, jmodel, jvars, rect=False):
    ev = JEvaler(data, workers=0, half=False, **KW)
    loader, _ = ev.init_data("val", rect=rect)
    return ev, ev.predict(ev.make_infer_fn(jmodel, jvars), loader)


def test_predict_matches_jax_targets_exactly_and_detections_closely(synthetic, models):
    data, _, _ = synthetic
    jmodel, jvars, tmodel = models
    _, (want_p, want_t) = jax_predict(data, jmodel, jvars)
    ev = Evaler(data, workers=0, half=False, device="cpu", **KW)
    loader, dataset = ev.init_data("val")
    assert len(dataset) == 6  # a tail batch of 2, padded to 4
    got_p, got_t = ev.predict(ev.make_infer_fn(tmodel), loader)
    assert len(got_t) == len(want_t) == 6 and sum(map(len, want_t)) >= 6
    for g, w in zip(got_t, want_t):
        np.testing.assert_array_equal(g, w)
    assert sum(map(len, want_p)) > 0
    for g, w in zip(got_p, want_p):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 20:28], w[:, 20:28])
        np.testing.assert_allclose(g[:, :20], w[:, :20], rtol=1e-4, atol=1e-3)
    assert ev.eval(got_p, got_t) == JEvaler({}).eval(got_p, got_t)
    speed = ev.eval_speed()
    assert set(speed) == {"pre_ms", "infer_ms", "post_ms"} and speed["infer_ms"] > 0

    # the seed keeps every gate score and candidate IoU clear of its threshold
    imgs = np.concatenate([b[0] for b in ev.init_data("val")[0]])
    with torch.no_grad():
        pred = tmodel(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0)
    cls = pred[..., 13:]
    bounds = [0, 31, 55] + [55 + 37 * i for i in range(1, 7)]
    gate = torch.stack([cls[..., a:b].amax(-1) for a, b in zip(bounds, bounds[1:])], -1).mean(-1)
    assert (gate - KW["conf_thres"]).abs().min() > MARGIN
    for i in range(len(imgs)):
        boxes = xywh2xyxy(pred[i, gate[i] >= KW["conf_thres"], :4])
        assert (pairwise_iou(boxes, boxes) - KW["iou_thres"]).abs().min() > MARGIN


def test_rect_batches_have_the_jax_shapes(synthetic):
    import cv2

    from yololp_tpu.data.datasets import RectValLoader as JRect
    from yololp_tpu.data.datasets import TrainValDataset as JDataset
    from yololp_tpu_torch.data.datasets import RectValLoader, TrainValDataset

    data, _, root = synthetic
    rect = root / "rect" / "images" / "val"
    rect.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(40, 64), (64, 30), (50, 50), (20, 64), (64, 64)]):
        cv2.imwrite(str(rect / f"r{i}.jpg"), rng.integers(0, 255, (h, w, 3), np.uint8))
    for hyp in ({}, {"letterbox_return_int": True}):
        jl = JRect(JDataset(str(rect), img_size=IMG, hyp=hyp, task="val"), 2, IMG)
        tl = RectValLoader(TrainValDataset(str(rect), img_size=IMG, hyp=hyp, task="val"), 2, IMG)
        assert tl.batch_shapes == jl.batch_shapes and len(set(tl.batch_shapes)) > 1
        assert [list(b) for b in tl.batches] == [list(b) for b in jl.batches]
        for (ti, tlab, tm, tp, ts), (ji, jlab, jm, jp, js) in zip(tl, jl):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tlab, jlab)
            np.testing.assert_array_equal(tm, jm)
            assert tp == jp and ts == js


def test_dataset_items_and_label_cache_equal_jax(synthetic):
    from yololp_tpu.data.datasets import TrainValDataset as JDataset
    from yololp_tpu_torch.data.datasets import MAX_BOXES, TrainValDataset

    data, _, _ = synthetic
    hyp = {"test_load_size": 48, "letterbox_return_int": True}
    for h in ({}, hyp):
        tds = TrainValDataset(data["val"], img_size=IMG, hyp=h, task="val")
        jds = JDataset(data["val"], img_size=IMG, hyp=h, task="val")
        assert tds.img_paths == jds.img_paths and MAX_BOXES == jds.max_boxes
        for i in range(len(tds)):
            for g, w in zip(tds[i], jds[i]):
                if isinstance(g, np.ndarray):
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g == w
    # augment=True (the train protocol) is ported: seeded items equal JAX's
    import random

    aug = {"degrees": 5.0, "translate": 0.1, "scale": 0.3, "shear": 1.0, "mosaic": 0.5,
           "generate": 0.5, "gen_paste": 0.5}
    tds = TrainValDataset(data["val"], img_size=IMG, augment=True, hyp=aug, seed=2)
    jds = JDataset(data["val"], img_size=IMG, augment=True, hyp=aug, seed=2)
    for i in range(len(tds)):
        items = []
        for ds in (tds, jds):
            random.seed(i)
            np.random.seed(i)
            items.append(ds[i])
        for g, w in zip(*items):
            if isinstance(g, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


def test_run_eval_and_refusals(synthetic, models):
    data, _, _ = synthetic
    _, _, tmodel = models
    results, speed = run_eval(tmodel, None, data, workers=0, half=False, device="cpu", **{
        k: v for k, v in KW.items() if k != "max_det"})
    assert len(results) == 7 and len(results[5]) == 10
    ev = Evaler(data, device="cpu")
    # a mesh splits each batch over its replicas: the batch must divide
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        Evaler(data, batch_size=3, device="cpu").make_infer_fn(tmodel, mesh=["cpu", "cpu"])
    # native=True takes the native batch decoder (data/native.py), which
    # tests/test_torch_native.py holds against JAX's
    from yololp_tpu_torch.data.datasets import NativeValLoader

    loader, dataset = ev.init_data("val", native=True)
    assert isinstance(loader, NativeValLoader) and len(dataset) == 6
    # the "approx" selector takes the same candidates as "topk" off the TPU
    approx, _ = run_eval(tmodel, None, data, workers=0, half=False, device="cpu",
                         nms_selector="approx", **{k: v for k, v in KW.items() if k != "max_det"})
    assert approx == results


def test_cli_runs_end_to_end_on_cpu(synthetic, tmp_path, capsys):
    from yololp_tpu_torch.tools.eval import main

    _, ckpt, root = synthetic
    args = ["--device", "cpu", "--synthetic-data", str(root), "--conf-file", "yololpn",
            "--weights", ckpt, "--img-size", str(IMG), "--batch-size", "4", "--workers", "0",
            "--conf-thres", str(KW["conf_thres"])]
    results, _ = main(args + ["--save-json", "--save-dir", str(tmp_path / "val")])
    out = capsys.readouterr().out
    assert "AP per IoU bucket" in out and "mAP50-95=" in out and "speed per image" in out
    assert (tmp_path / "val" / "predictions.json").is_file()
    assert (tmp_path / "val" / "instances_val.json").is_file()
    rect, _ = main(args + ["--rect"])
    assert len(rect) == 7
    # --mesh 2 splits each batch over two replicas (here both on the CPU)
    meshed, _ = main(args + ["--mesh", "2"])
    assert meshed == results
    # the synthetic frames are IMG square: the native decoder's letterbox is
    # the identity on them, as the per-image loader's is
    native, _ = main(args + ["--native-preproc"])
    assert native == results
    # --nms-selector approx, through the mesh's NMS call too
    approx, _ = main(args + ["--nms-selector", "approx", "--mesh", "2"])
    assert approx == results
