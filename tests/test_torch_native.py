"""Port parity: the encoded-image path (data/native.py, NativeValLoader,
Inferer.detect_batch_encoded and infer_batched's encoded branch) against
the JAX package on the same encoded bytes.

The port builds native/preproc/preproc.cpp into build/preproc/; the JAX
functions are pointed at that same library for these tests (their module's
_LIB_PATH, monkeypatched), so the two packages decode with one library and
must agree bit for bit. The inferer cases run yololpn in fp32 on
tests/test_torch_inferer.py's checkpoint and PNG-encoded frames (lossless:
the frames whose gate scores and IoUs that file checks keep clear of their
thresholds), within its tolerance.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_inferer import KW, assert_dets_match, ckpt, images  # noqa: F401  (fixtures)
from yololp_tpu.core.inferer import Inferer as JInferer
from yololp_tpu.data import native as jnative
from yololp_tpu.data.datasets import NativeValLoader as JNativeValLoader
from yololp_tpu.data.datasets import TrainValDataset as JTrainValDataset
from yololp_tpu_torch.core.inferer import Inferer
from yololp_tpu_torch.data import native
from yololp_tpu_torch.data.datasets import NativeValLoader, TrainValDataset

torch.set_num_threads(2)

SIZES = [(480, 640), (600, 400), (320, 320), (200, 260)]  # the last smaller than 320
ROW = [3, 5, 1, 2, 3, 4, 5, 36, 0.5, 0.5, 0.4, 0.2, 0.3, 0.4, 0.3, 0.6, 0.7, 0.6, 0.7, 0.4]


def gradient(h, w):
    gy = np.linspace(0, 255, h, dtype=np.float32)[:, None]
    gx = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    return np.stack([gy + 0 * gx, 0 * gy + gx, (gy + gx) / 2], -1).astype(np.uint8)


@pytest.fixture
def shared_lib(monkeypatch):
    """The JAX module pointed at the port-built library."""
    path = native.build()
    monkeypatch.setattr(jnative, "_LIB_PATH", str(path))
    monkeypatch.setattr(jnative, "_lib", None)
    assert native.native_available() and jnative.native_available()
    return path


@pytest.fixture(scope="module")
def jpegs():
    rng = np.random.default_rng(5)
    bufs = [cv2.imencode(".jpg", gradient(h, w), [cv2.IMWRITE_JPEG_QUALITY, 98])[1].tobytes()
            for h, w in SIZES]
    bufs.append(cv2.imencode(".png", rng.integers(0, 256, (90, 150, 3), np.uint8))[1].tobytes())
    return bufs


def assert_decodes_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scaleup", [True, False])
def test_native_decode_equals_jax_on_one_library(shared_lib, jpegs, scaleup):
    assert shared_lib.parent.name == "preproc" and shared_lib.parent.parent.name == "build"
    got = native.decode_letterbox_batch(jpegs, 320, scaleup=scaleup)
    want = jnative.decode_letterbox_batch(jpegs, 320, scaleup=scaleup)
    assert_decodes_equal(got, want)
    imgs, ratios, pads_w, pads_h = got
    assert imgs.shape == (len(jpegs), 320, 320, 3)
    # 200x260 is padded, never upscaled, under scaleup=False
    assert (ratios[3] == 1.0) != scaleup and (ratios[3] > 1.0) == scaleup
    assert (pads_w >= 0).all() and (pads_h >= 0).all()


@pytest.mark.parametrize("scaleup", [True, False])
def test_cv2_fallback_equals_jax(jpegs, scaleup):
    got = native._cv2_fallback(jpegs, 320, scaleup)
    want = jnative._cv2_fallback(jpegs, 320, scaleup)
    assert_decodes_equal(got, want)


def test_undecodable_buffer_keeps_its_slot(shared_lib, jpegs):
    bufs = [jpegs[0], b"not an image", jpegs[2]]
    with pytest.warns(UserWarning, match="1/3"):
        got = native.decode_letterbox_batch(bufs, 128)
    with pytest.warns(UserWarning, match="1/3"):
        want = jnative.decode_letterbox_batch(bufs, 128)
    assert_decodes_equal(got, want)
    assert (got[0][1] == 114).all() and got[1][1] == 1.0
    assert_decodes_equal(native._cv2_fallback(bufs, 128), jnative._cv2_fallback(bufs, 128))


def test_native_val_loader_equals_jax(shared_lib, tmp_path):
    root = tmp_path
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i, (h, w) in enumerate(SIZES):
        cv2.imwrite(str(root / "images" / "val" / f"n{i}.jpg"), gradient(h, w),
                    [cv2.IMWRITE_JPEG_QUALITY, 98])
        (root / "labels" / "val" / f"n{i}.txt").write_text(" ".join(str(v) for v in ROW))
    img_dir = str(root / "images" / "val")
    got = list(NativeValLoader(TrainValDataset(img_dir, img_size=320, task="val"), 3, 320))
    want = list(JNativeValLoader(JTrainValDataset(img_dir, img_size=320, task="val"), 3, 320))
    assert len(got) == len(want) == 2
    for (gi, gl, gm, gp, gs), (wi, wl, wm, wp, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-6)
        assert gp == wp and gs == ws
        assert gm.sum() == len(gp)


@pytest.fixture(scope="module")
def pngs(images):
    return [cv2.imencode(".png", im)[1].tobytes() for im in images]


def test_detect_batch_encoded_matches_jax(shared_lib, ckpt, pngs, tmp_path):
    jinf = JInferer(str(tmp_path), ckpt, "yololpn", **KW)
    inf = Inferer(str(tmp_path), ckpt, "yololpn", device="cpu", **KW)
    got, want = inf.detect_batch_encoded(pngs), jinf.detect_batch_encoded(pngs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(w) > 0
        assert_dets_match(g, w)
        assert [inf.plate_text(d) for d in g] == [jinf.plate_text(d) for d in w]


def test_non_square_branch_keeps_an_undecodable_slot(shared_lib, ckpt, pngs, tmp_path):
    kw = {**KW, "img_size": (128, 160)}
    jinf = JInferer(str(tmp_path), ckpt, "yololpn", **kw)
    inf = Inferer(str(tmp_path), ckpt, "yololpn", device="cpu", **kw)
    bufs = [pngs[0], b"\x00broken", pngs[1]]
    got, want = inf.detect_batch_encoded(bufs), jinf.detect_batch_encoded(bufs)
    assert len(got) == len(want) == 3
    assert got[1].shape == want[1].shape == (0, 28)
    for g, w in zip(got, want):
        assert_dets_match(g, w)
    assert len(got[0]) > 0 and len(got[2]) > 0


def _labels(path):
    rows = [line.split() for line in open(path, encoding="utf-8")]
    return np.array([[float(v) for v in r[:13]] for r in rows]), [r[13] for r in rows]


def test_infer_batched_takes_the_encoded_route_like_jax(shared_lib, ckpt, images, tmp_path,
                                                        monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for i, im in enumerate(images + [images[0][:, ::-1]]):
        cv2.imwrite(str(src / f"im{i}.png"), im)
    jinf = JInferer(str(src), ckpt, "yololpn", **KW)
    inf = Inferer(str(src), ckpt, "yololpn", device="cpu", **KW)
    calls, jcalls = [], []
    orig, jorig = Inferer.detect_batch_encoded, JInferer.detect_batch_encoded
    monkeypatch.setattr(Inferer, "detect_batch_encoded",
                        lambda self, bufs: calls.append(len(bufs)) or orig(self, bufs))
    monkeypatch.setattr(JInferer, "detect_batch_encoded",
                        lambda self, bufs: jcalls.append(len(bufs)) or jorig(self, bufs))
    results = inf.infer_batched(str(tmp_path / "t"), batch_size=2)
    jinf.infer_batched(str(tmp_path / "j"), batch_size=2)
    assert calls == jcalls == [2, 2]  # 2 + the padded tail of 2
    assert [os.path.basename(p) for p, _ in results] == ["im0.png", "im1.png", "im2.png"]
    for i in range(3):
        want, want_text = _labels(tmp_path / "j" / "labels" / f"im{i}.txt")
        got, got_text = _labels(tmp_path / "t" / "labels" / f"im{i}.txt")
        assert got_text == want_text and len(got_text) > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)  # printed to 4 decimals


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "preproc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "opencv_present", lambda: True)
    with pytest.raises(RuntimeError, match="building the native batch decoder failed") as e:
        native.decode_letterbox_batch([b"x"], 64)
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").iterdir())  # no half-written library


def test_no_opencv_and_no_cv2_raises_naming_both(monkeypatch, tmp_path, pngs):
    import sys

    from yololp_tpu_torch.core.evaler import Evaler

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "opencv_present", lambda: False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert not native.native_available()
    match = "neither the native batch decoder .* nor the cv2 module"
    with pytest.raises(RuntimeError, match=match):
        native.decode_letterbox_batch(pngs, 64)
    inf = Inferer(str(tmp_path), None, "yololpn", img_size=64, half=False, device="cpu")
    with pytest.raises(RuntimeError, match=match):
        inf.detect_batch_encoded(pngs)
    (tmp_path / "images").mkdir()
    (tmp_path / "images" / "a.jpg").write_bytes(b"x")
    with pytest.raises(RuntimeError, match=match):
        Evaler({"val": str(tmp_path / "images")}, device="cpu").init_data("val", native=True)
