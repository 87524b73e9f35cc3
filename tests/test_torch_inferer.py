"""Port parity: the yololpn `Inferer` at 128 px in fp32, JAX against the port
on the CPU, from one saved checkpoint.

Counts and plate strings must be identical; boxes, corners and confidences
equal within rtol 1e-4 / atol 1e-3 (the fp32 conv-order differences of
tests/test_torch_models.py, carried through the letterbox rescale). Exact
counts need every gate score and every candidate IoU to sit clear of its
threshold by more than that tolerance; `test_seed_keeps_clear_of_thresholds`
checks this for the chosen seed and images (seed 41 does; pick another seed
if a change of weights ever breaks it).
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_models import jax_variables
from yololp_tpu.core.inferer import Inferer as JInferer
from yololp_tpu.utils import checkpoint as jckpt
from yololp_tpu_torch.core.inferer import Inferer
from yololp_tpu_torch.ops.geometry import pairwise_iou, xywh2xyxy

torch.set_num_threads(2)

KW = dict(img_size=128, half=False, conf_thres=0.5, iou_thres=0.45, max_det=20)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("inf") / "yololpn.msgpack")
    jckpt.save_checkpoint({"format": "train", "step": 0,
                           "variables": jax_variables("yololpn", seed=41),
                           "ema": None, "opt_state": None, "meta": {}}, path)
    return path


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(4)
    # one needs a resize (cv2), one only a pad
    return [rng.integers(0, 255, (200, 260, 3), np.uint8),
            rng.integers(0, 255, (128, 96, 3), np.uint8)]


@pytest.fixture(scope="module")
def inferers(ckpt, tmp_path_factory):
    src = str(tmp_path_factory.mktemp("src"))
    return (JInferer(src, ckpt, "yololpn", **KW),
            Inferer(src, ckpt, "yololpn", device="cpu", **KW))


def assert_dets_match(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 20:28], want[:, 20:28])  # class ids
    np.testing.assert_allclose(got[:, :20], want[:, :20], rtol=1e-4, atol=1e-3)


def test_seed_keeps_clear_of_thresholds(inferers, images):
    _, inf = inferers
    pred = inf.predict(np.stack([inf.precess_image(im) for im in images]))
    cls = pred[..., 13:]
    bounds = [0, 31, 55] + [55 + 37 * i for i in range(1, 7)]
    gate = torch.stack([cls[..., a:b].amax(-1) for a, b in zip(bounds, bounds[1:])], -1).mean(-1)
    assert (gate - KW["conf_thres"]).abs().min() > MARGIN
    passed = gate >= KW["conf_thres"]
    assert passed.sum(-1).min() > KW["max_det"] // 2  # NMS has work to do
    for i in range(len(images)):
        boxes = xywh2xyxy(pred[i, passed[i], :4])
        iou = pairwise_iou(boxes, boxes)
        assert (iou - KW["iou_thres"]).abs().min() > MARGIN


def test_detect_and_detect_batch_match_jax(inferers, images):
    jinf, inf = inferers
    for im in images:
        want, got = jinf.detect(im), inf.detect(im)
        assert len(want) > 0
        assert_dets_match(got, want)
        assert [inf.plate_text(d) for d in got] == [jinf.plate_text(d) for d in want]
    for got, want in zip(inf.detect_batch(images), jinf.detect_batch(images)):
        assert_dets_match(got, want)
    assert inf.fps_calc.accumulate() > 0


def _labels(path):
    rows = [line.split() for line in open(path, encoding="utf-8")]
    return np.array([[float(v) for v in r[:13]] for r in rows]), [r[13] for r in rows]


@pytest.mark.parametrize("batched", [False, True])
def test_infer_label_files_match_jax(inferers, images, tmp_path, batched):
    import cv2

    jinf, inf = inferers
    src = tmp_path / "src"
    src.mkdir()
    for i, im in enumerate(images):
        cv2.imwrite(str(src / f"im{i}.png"), im)
    jinf.source = inf.source = str(src)
    # the JAX batched path feeds still images through its native encoded-bytes
    # letterbox, which the port defers; both port paths are held to JAX infer
    jinf.infer(str(tmp_path / "j"), save_img=False)
    if batched:
        results = inf.infer_batched(str(tmp_path / "t"), batch_size=4)
    else:
        results = inf.infer(str(tmp_path / "t"))
    assert len(results) == len(images)
    for i in range(len(images)):
        want, want_text = _labels(tmp_path / "j" / "labels" / f"im{i}.txt")
        got, got_text = _labels(tmp_path / "t" / "labels" / f"im{i}.txt")
        assert got_text == want_text and len(got_text) > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)  # printed to 4 decimals


def test_cli_runs_on_cpu(ckpt, images, tmp_path):
    import cv2

    from yololp_tpu_torch.tools.infer import main

    cv2.imwrite(str(tmp_path / "a.png"), images[0])
    main(["--source", str(tmp_path / "a.png"), "--conf-file", "yololpn", "--weights", ckpt,
          "--img-size", "128", "--device", "cpu", "--conf-thres", "0.5", "--not-save-img",
          "--project", str(tmp_path / "out")])
    assert (tmp_path / "out" / "exp" / "labels" / "a.txt").read_text(encoding="utf-8")
