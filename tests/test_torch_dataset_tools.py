"""The port's dataset tools (yololp_tpu_torch/tools/{make_dataset,
generate_plates,trans_ccpd,count_ccpd,voc2yolo,vis_dataset,vis_glyphs}.py)
against the JAX package's (tools/) on inputs made in the test: the same
files, byte for byte, and the same printed counts. CCPD inputs are
placeholder files under CCPD-style names (the annotation lives in the
name); no CCPD image is written."""

import json
import os
import random
import sys
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (forces the JAX cpu backend)
from tools import (count_ccpd as jcount_ccpd, generate_plates as jgenerate_plates,
                   make_dataset as jmake_dataset, trans_ccpd as jtrans_ccpd,
                   vis_dataset as jvis_dataset, vis_glyphs as jvis_glyphs,
                   voc2yolo as jvoc2yolo)
from yololp_tpu_torch.tools import (count_ccpd, generate_plates, make_dataset, trans_ccpd,
                                    vis_dataset, vis_glyphs, voc2yolo)


def tree(root: Path) -> dict:
    """{relative path: bytes, or the link's target for a symlink}."""
    out = {}
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root).as_posix()
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.is_file():
            out[rel] = p.read_bytes()
    return out


def run_jax_main(main, argv, monkeypatch):
    """A JAX tool whose main() reads sys.argv."""
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["tool"] + argv)
        return main()


def test_make_dataset_equals_jax(tmp_path, capsys):
    args = ["--n-train", "3", "--n-val", "2", "--img-size", "64", "--chunk", "2", "--seed", "1"]
    data = make_dataset.main(["--root", str(tmp_path / "t" / "ds")] + args)
    got = capsys.readouterr().out.replace(str(tmp_path / "t"), "OUT")
    jmake_dataset.main(["--root", str(tmp_path / "j" / "ds")] + args)
    want = capsys.readouterr().out.replace(str(tmp_path / "j"), "OUT")
    strip = [line.split("  (")[0] for line in got.splitlines()]  # elapsed seconds
    assert strip == [line.split("  (")[0] for line in want.splitlines()]
    assert strip[:3] == ["train 2/3", "train 3/3", "val 2/2"]
    t, j = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert t.keys() == j.keys() and len(t) == 11  # 5 images, 5 labels, the yaml
    for k in t:
        if k.endswith(".yaml"):
            assert t[k].replace(str(tmp_path / "t").encode(), b"") == \
                j[k].replace(str(tmp_path / "j").encode(), b"")
        else:
            assert t[k] == j[k], k
    assert data["val"] == str(tmp_path / "t" / "ds" / "images" / "val")
    # a rerun resumes at the chunk boundary and rewrites the yaml only
    make_dataset.main(["--root", str(tmp_path / "t" / "ds")] + args)
    assert "resuming at train image 2" in capsys.readouterr().out
    assert tree(tmp_path / "t") == t


@pytest.mark.parametrize("style", [None, "green_b"])
def test_generate_plates_equals_jax(tmp_path, capsys, style):
    args = ["--n", "3", "--seed", "2"] + (["--style", style] if style else [])
    generate_plates.main(["--out", str(tmp_path / "t")] + args)
    got = capsys.readouterr().out.replace(str(tmp_path / "t"), "OUT")
    jgenerate_plates.main(["--out", str(tmp_path / "j")] + args)
    assert got == capsys.readouterr().out.replace(str(tmp_path / "j"), "OUT")
    t = tree(tmp_path / "t")
    assert t == tree(tmp_path / "j") and len(t) == 6


def ccpd_name(rng, is_2020, valid=True):
    """A CCPD-style file name: area-tilt-box-corners-plate-bright-blur."""
    x1, y1 = int(rng.integers(50, 300)), int(rng.integers(200, 800))
    x2, y2 = x1 + int(rng.integers(80, 300)), y1 + int(rng.integers(30, 120))
    corners = f"{x2}&{y2}_{x1}&{y2}_{x1}&{y1}_{x2}&{y1}"
    n = 8 if is_2020 else 7
    plate = [int(rng.integers(0, 31)), int(rng.integers(0, 24))] + \
        [int(rng.integers(0, 34)) for _ in range(n - 2)]
    if not valid:
        plate[0] = 40  # province out of range
    return (f"025-95_113-{x1}&{y1}_{x2}&{y2}-{corners}-{'_'.join(map(str, plate))}"
            f"-{int(rng.integers(50, 200))}-{int(rng.integers(1, 30))}.jpg")


def make_ccpd(root: Path, rng):
    """CCPD2019's splits/*.txt over ccpd_base/ and CCPD2020's
    ccpd_green/{train,val,test}, placeholder bytes under CCPD names."""
    c19, c20 = root / "CCPD2019", root / "CCPD2020"
    (c19 / "splits").mkdir(parents=True)
    (c19 / "ccpd_base").mkdir()
    for split, n in (("train", 3), ("val", 2)):  # no test split: skipped
        names = [ccpd_name(rng, False, valid=i != 1) for i in range(n)]
        for name in names:
            (c19 / "ccpd_base" / name).write_bytes(b"placeholder")
        (c19 / "splits" / f"{split}.txt").write_text(
            "\n".join(f"ccpd_base/{name}" for name in names) + "\n")
    for split, n in (("train", 2), ("val", 1), ("test", 2)):
        d = c20 / "ccpd_green" / split
        d.mkdir(parents=True)
        for i in range(n):
            (d / ccpd_name(rng, True)).write_bytes(b"placeholder")
    (c20 / "ccpd_green" / "test" / "bad-name.jpg").write_bytes(b"placeholder")
    return c19, c20


@pytest.mark.parametrize("link", [False, True])
def test_trans_ccpd_equals_jax(tmp_path, capsys, monkeypatch, link):
    c19, c20 = make_ccpd(tmp_path / "src", np.random.default_rng(3))
    args = ["--ccpd2019", str(c19), "--ccpd2020", str(c20)] + (["--link"] if link else [])
    indices = trans_ccpd.main(args + ["--output", str(tmp_path / "t")])
    got = capsys.readouterr().out
    run_jax_main(jtrans_ccpd.main, args + ["--output", str(tmp_path / "j")], monkeypatch)
    assert got == capsys.readouterr().out
    assert indices == {"train": 5, "val": 3, "test": 3}
    assert "2019 train: 3 total, 1 invalid labels" in got and "skip 2019 test" in got
    t = tree(tmp_path / "t")
    assert t == tree(tmp_path / "j") and len(t) == 22
    rows = [v.decode().split() for k, v in t.items() if k.startswith("labels/")]
    assert sum(len(r) == 20 for r in rows) == 8 and sum(len(r) == 0 for r in rows) == 3
    with pytest.raises(SystemExit):
        trans_ccpd.main(["--output", str(tmp_path / "none")])


def test_count_ccpd_equals_jax(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(4)
    labels = tmp_path / "labels"
    labels.mkdir()
    for i in range(5):
        rows = [[int(rng.integers(0, 31)), int(rng.integers(0, 24))]
                + [int(v) for v in rng.integers(0, 37, 6)] + list(rng.uniform(0, 1, 12))
                for _ in range(i % 3)]
        (labels / f"l{i}.txt").write_text("\n".join(" ".join(map(str, r)) for r in rows))
    stats = count_ccpd.main(["--labels", str(labels), "--out", str(tmp_path / "t")])
    got = capsys.readouterr().out.replace(str(tmp_path / "t"), "OUT")
    run_jax_main(jcount_ccpd.main, ["--labels", str(labels), "--out", str(tmp_path / "j")],
                 monkeypatch)
    assert got == capsys.readouterr().out.replace(str(tmp_path / "j"), "OUT")
    assert (stats["n_plates"], stats["n_empty_images"]) == (4, 2)
    got_json = json.loads((tmp_path / "t" / "stats.json").read_text(encoding="utf-8"))
    assert got_json == json.loads((tmp_path / "j" / "stats.json").read_text(encoding="utf-8"))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


_XML = """<annotation>
  <size><width>200</width><height>100</height><depth>3</depth></size>
  <object><name>car</name><difficult>0</difficult>
    <bndbox><xmin>50</xmin><ymin>20</ymin><xmax>150</xmax><ymax>80</ymax></bndbox></object>
  <object><name>person</name><difficult>1</difficult>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>10</xmax><ymax>10</ymax></bndbox></object>
  <object><name>dog</name><difficult>0</difficult>
    <bndbox><xmin>3</xmin><ymin>5</ymin><xmax>90</xmax><ymax>60</ymax></bndbox></object>
</annotation>
"""


def make_voc(root: Path):
    """tests/test_voc2yolo.py's layout: 2007 train and test, 2012 train."""
    for year, image_set, ids in (("2007", "train", ["a1", "a2"]), ("2007", "test", ["t1"]),
                                 ("2012", "train", ["b1"])):
        voc = root / f"VOC{year}"
        for d in ("ImageSets/Main", "JPEGImages", "Annotations"):
            (voc / d).mkdir(parents=True, exist_ok=True)
        (voc / "ImageSets" / "Main" / f"{image_set}.txt").write_text("\n".join(ids))
        for i in ids:
            (voc / "JPEGImages" / f"{i}.jpg").write_bytes(b"\xff\xd8fakejpg" + i.encode())
            (voc / "Annotations" / f"{i}.xml").write_text(_XML)


@pytest.mark.parametrize("link", [False, True])
def test_voc2yolo_equals_jax(tmp_path, capsys, link):
    make_voc(tmp_path / "t")
    make_voc(tmp_path / "j")
    flag = ["--link"] if link else []
    voc2yolo.main(["--voc-path", str(tmp_path / "t")] + flag)
    got = capsys.readouterr().out.replace(str(tmp_path / "t"), "ROOT")
    jvoc2yolo.main(["--voc-path", str(tmp_path / "j")] + flag)
    assert got == capsys.readouterr().out.replace(str(tmp_path / "j"), "ROOT")
    t = tree(tmp_path / "t")
    assert t == tree(tmp_path / "j")
    assert sorted(k for k in t if k.startswith("voc_07_12/images/train/")) == [
        f"voc_07_12/images/train/{n}.jpg" for n in ("a1", "a2", "b1")]
    assert t["voc_07_12/labels/val/t1.txt"].decode().count("\n") == 2  # car, dog


@pytest.mark.parametrize("augment", [False, True])
def test_vis_dataset_equals_jax(tmp_path, capsys, augment):
    from yololp_tpu_torch.data.synthetic import make_synthetic_dataset

    data = make_synthetic_dataset(str(tmp_path / "ds"), n_train=4, n_val=0, img_size=96, seed=5)
    args = ["--img-dir", data["train"], "--n", "3", "--img-size", "96", "--seed", "3"]
    args += ["--augment"] if augment else []
    outs = []
    for main, side in ((vis_dataset.main, "t"), (jvis_dataset.main, "j")):
        # the augmentation draws from numpy's and Python's global streams
        np.random.seed(11)
        random.seed(11)
        main(args + ["--out", str(tmp_path / side)])
        outs.append(capsys.readouterr().out.replace(str(tmp_path / side), "OUT"))
    assert outs[0] == outs[1] == "3 annotated samples + grid.jpg written to OUT\n"
    t = tree(tmp_path / "t")
    assert t == tree(tmp_path / "j") and len(t) == 4


def test_vis_glyphs_equals_jax(tmp_path, capsys):
    vis_glyphs.main(["--out", str(tmp_path / "t.png"), "--cell", "32"])
    got = capsys.readouterr().out
    jvis_glyphs.main(["--out", str(tmp_path / "j.png"), "--cell", "32"])
    assert got.replace("t.png", "x") == capsys.readouterr().out.replace("j.png", "x")
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
