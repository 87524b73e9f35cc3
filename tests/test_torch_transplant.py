"""Port parity: utils/transplant.py:to_torch_state_dict against the JAX
function on the same flax-layout tree: equal keys, shapes and values. The
trees are randomized (every leaf perturbed, as tests/test_transplant.py
does) and cover the repvgg family (yololpn) and the conv_silu one (yolov6l:
BepC3), both with BiFusion's ConvTranspose and its spatial flip, plus the
tree the port itself writes for a model of its own (utils/convert.py).

The tests that build the reference YOLOv6 model skip without the reference
tree, as tests/test_transplant.py does.
"""

import zlib

import numpy as np
import pytest
import torch

import jax

from conftest import REFERENCE_DIR, reference_available
from test_transplant import _perturb
from yololp_tpu.models.yolo import build_model as jbuild_model
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu.utils.transplant import to_torch_state_dict as jto_torch_state_dict
from yololp_tpu_torch.utils import transplant
from yololp_tpu_torch.utils.config import Config

torch.set_num_threads(2)

requires_reference = pytest.mark.skipif(not reference_available(),
                                        reason="reference tree not present")


def flax_tree(conf):
    _, variables = jbuild_model(JConfig.named(conf), img_size=(64, 64), batch_size=1)
    variables = _perturb(variables, seed=zlib.crc32(conf.encode()))
    return jax.tree.map(np.asarray, variables)


def assert_state_dicts_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("conf", ["yololpn", "yolov6l"])
def test_state_dict_equals_jax(conf):
    tree = flax_tree(conf)
    reg_max = int(Config.named(conf).model.head.reg_max)
    got = transplant.to_torch_state_dict(tree, reg_max=reg_max)
    want = jto_torch_state_dict(tree, reg_max=reg_max)
    assert_state_dicts_equal(got, want)
    # the 8-way cls split and the reg split of the head
    assert got["detect.pro_preds.0.weight"].shape[0] == 31
    assert got["detect.ad5_preds.2.weight"].shape[0] == 37
    assert got["detect.cor_preds.1.weight"].shape[0] == 8
    assert got["detect.reg_preds.0.weight"].shape[0] == 4 * (reg_max + 1)
    flipped = [k for k in got if "upsample_transpose" in k and k.endswith("weight")]
    assert len(flipped) == 2  # each neck has two BiFusion upsamples
    for k in flipped:  # HWIO -> flipped -> IOHW
        path = k.removesuffix(".weight").split(".")
        leaf = tree["params"]
        for p in path:
            leaf = leaf[p]
        np.testing.assert_array_equal(got[k], leaf["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))


def test_state_dict_of_the_ports_own_tree_equals_jax():
    """The tree utils/convert.py writes for a port model (train format, as
    a port checkpoint holds it)."""
    from test_torch_zoo import random_jax_variables
    from yololp_tpu_torch.models.yolo import Model

    tree = random_jax_variables(Model(Config.named("yololps")), 5)
    assert_state_dicts_equal(transplant.to_torch_state_dict(tree, reg_max=0),
                             jto_torch_state_dict(tree, reg_max=0))


def test_unknown_leaves_raise():
    tree = flax_tree("yololpn")
    tree["params"]["backbone"]["stem"]["rbr_dense_conv"]["odd"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="odd"):
        transplant.to_torch_state_dict(tree)


def test_cli_writes_the_jax_state_dict(tmp_path, capsys):
    from yololp_tpu_torch.tools.transplant import main
    from yololp_tpu_torch.utils.checkpoint import save_checkpoint

    tree = flax_tree("yolov6l")
    ckpt = str(tmp_path / "w.msgpack")
    save_checkpoint({"format": "train", "variables": tree, "ema": None}, ckpt)
    sd = main(["--weights", ckpt, "--conf-file", "yolov6l", "--out", str(tmp_path / "sd.pt")])
    assert "converted" in capsys.readouterr().out
    saved = torch.load(str(tmp_path / "sd.pt"))
    want = jto_torch_state_dict(tree, reg_max=int(Config.named("yolov6l").model.head.reg_max))
    assert_state_dicts_equal({k: v.numpy() for k, v in saved.items()}, want)
    assert_state_dicts_equal(sd, want)
    save_checkpoint({"format": "deploy", "variables": tree}, str(tmp_path / "d.msgpack"))
    with pytest.raises(SystemExit, match="train-format"):
        main(["--weights", str(tmp_path / "d.msgpack"), "--conf-file", "yolov6l"])


def test_make_subset_symlinks_resolve_from_relative_yaml(tmp_path, monkeypatch):
    """tests/test_transplant.py's regression case: relative dataset paths
    give symlinks that resolve from the work dir."""
    import os

    from yololp_tpu_torch.tools.transplant import make_subset

    src = tmp_path / "ds" / "images" / "val"
    lbl = tmp_path / "ds" / "labels" / "val"
    src.mkdir(parents=True)
    lbl.mkdir(parents=True)
    (src / "a.jpg").write_bytes(b"x")
    (src / "b.jpg").write_bytes(b"y")
    (lbl / "a.txt").write_text("0 0 0 0 0 0 0 0 .5 .5 .1 .1 .45 .45 .45 .55 .55 .55 .55 .45\n")
    monkeypatch.chdir(tmp_path)
    yml = tmp_path / "data.yaml"
    yml.write_text(f"val: {os.path.relpath(src, tmp_path)}\nnpro: 31\nnalp: 24\nnads: 37\n")
    work = tmp_path / "work"
    work.mkdir()
    sub, img_dir = make_subset(str(yml), 1, str(work))
    link = os.path.join(img_dir, "a.jpg")
    assert os.path.islink(link) and os.path.exists(link)
    assert os.listdir(img_dir) == ["a.jpg"]
    assert os.path.exists(work / "labels" / "val" / "a.txt")
    assert sub["val"] == img_dir and sub["nads"] == 37


@requires_reference
@pytest.mark.parametrize("conf", ["yololpn", "yolov6l"])
def test_transplanted_port_model_matches_reference_forward(conf):
    """The port's train-graph model in eval mode and the reference model
    loaded with the transplant of the port's own tree: the same (1, A, 290)
    output."""
    from test_torch_zoo import random_jax_variables
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

    cfg = Config.named(conf)
    model = Model(cfg)
    tree = random_jax_variables(model, zlib.crc32(conf.encode()))
    load_state_dict_strict(model, jax_to_state_dict(tree))
    ref = transplant.build_reference_model(cfg, reference_dir=REFERENCE_DIR)
    transplant.load_into_reference(
        ref, transplant.to_torch_state_dict(tree, reg_max=int(cfg.model.head.reg_max)))
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        ours = model.eval()(x)
        theirs = ref(x)[0]
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=2e-3, atol=5e-3)


def test_reference_dir_has_no_default(monkeypatch, tmp_path):
    """Nothing finds the reference tree by itself: without --reference-dir
    (reference_dir=) or $YOLOLP_REFERENCE_DIR, building the reference model
    and transplant's --data refuse before reading any file."""
    from yololp_tpu_torch.tools import transplant as tool

    monkeypatch.delenv(transplant.REFERENCE_ENV, raising=False)
    with pytest.raises(ValueError, match="YOLOLP_REFERENCE_DIR"):
        transplant.resolve_reference_dir()
    with pytest.raises(ValueError, match="--reference-dir"):
        transplant.build_reference_model(Config.named("yololpn"))
    missing = str(tmp_path / "missing")
    with pytest.raises(ValueError, match="--reference-dir"):
        tool.main(["--weights", missing, "--conf-file", "yololpn", "--data", missing,
                   "--device", "cpu"])


def test_reference_dir_from_flag_or_environment(monkeypatch, tmp_path):
    monkeypatch.delenv(transplant.REFERENCE_ENV, raising=False)
    assert transplant.resolve_reference_dir(str(tmp_path)) == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="reference YOLOv6 tree not found"):
        transplant.resolve_reference_dir(str(tmp_path / "missing"))
    monkeypatch.setenv(transplant.REFERENCE_ENV, str(tmp_path))
    assert transplant.resolve_reference_dir() == str(tmp_path)
