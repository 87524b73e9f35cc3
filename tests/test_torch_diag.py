"""The port's diagnostics against the JAX tools: tools.diag_strict and
tools.diag_province print the JAX tools' reports (tools/diag_strict.py,
tools/diag_province.py) on one yololpn checkpoint the port writes (every
weight drawn from a seed) and a synthetic 64 px val set, both models in
fp32 (the JAX tools build theirs in bf16: patched here, as
tests/test_torch_tools.py does for the sensitivity tool).

The set is labelled with the float model's own detections, and some labels
are then spoiled by fixed amounts, so every stage of the funnel is crossed:
a box narrowed to 0.6 of its width (IoU 0.6: matched at 0.5, not at 0.7),
characters moved (a confusion), corners moved by 0.3 sqrt(area) (the corner
criterion fails). tools.diag_scan_walls prints its keys on the CPU.
"""

import json

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX cpu backend)

torch.set_num_threads(2)

IMG = 64


def _spoiled_label(path, det, size):
    """Write the label file of the image at `path` from its detections (n,
    28) in pixels: normalized classes, cxcywh and corners, each clipped to
    the frame, with every second label's characters, every third's width
    and every fourth's corners spoiled."""
    det = det[:6].astype(np.float64)
    box = np.clip(det[:, :4], 0, size)
    keep = (box[:, 2] - box[:, 0] > 1) & (box[:, 3] - box[:, 1] > 1)
    det, box = det[keep], box[keep]
    cls = det[:, 20:28].astype(int)
    cors = np.clip(det[:, 4:12], 0, size)
    for j in range(len(det)):
        if j % 2 == 1:
            cls[j, 0] = (cls[j, 0] + 3) % 31
            cls[j, 4] = (cls[j, 4] + 1) % 37
        if j % 3 == 1:
            box[j, 2] = box[j, 0] + 0.6 * (box[j, 2] - box[j, 0])
        if j % 4 == 3:
            side = np.sqrt((box[j, 2] - box[j, 0]) * (box[j, 3] - box[j, 1]))
            centre = np.tile((box[j, :2] + box[j, 2:]) / 2, 4)
            cors[j] += np.where(cors[j] < centre, 0.3, -0.3) * side
    box, cors = box / size, cors / size
    rows = np.concatenate([cls, (box[:, :2] + box[:, 2:]) / 2, box[:, 2:] - box[:, :2], cors], 1)
    label = path.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt"
    with open(label, "w") as f:
        for r in rows:
            f.write(" ".join([str(int(v)) for v in r[:8]] + [f"{v:.6f}" for v in r[8:]]) + "\n")


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    from test_torch_zoo import random_jax_variables
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.data.synthetic import make_synthetic_dataset
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.utils.checkpoint import save_checkpoint
    from yololp_tpu_torch.utils.config import Config

    tmp = tmp_path_factory.mktemp("diag")
    ckpt, data = str(tmp / "w.msgpack"), str(tmp / "data")
    save_checkpoint({"format": "train",
                     "variables": random_jax_variables(Model(Config.named("yololpn")), 7)}, ckpt)
    make_synthetic_dataset(data, n_train=1, n_val=6, img_size=IMG, seed=0)
    inf = Inferer(None, ckpt, "yololpn", img_size=IMG, half=False, device="cpu")
    ev = Evaler({"val": f"{data}/images/val"}, 2, IMG, workers=0, device="cpu")
    preds, _ = ev.predict(ev.make_infer_fn(inf.model), ev.init_data("val")[0])
    for path, det in zip(ev.last_paths, preds):
        _spoiled_label(path, det, IMG)
    yaml = tmp / "data.yaml"
    yaml.write_text(f"val: {data}/images/val\nnpro: 31\nnalp: 24\nnads: 37\n")
    return ckpt, str(yaml)


@pytest.fixture
def fp32_jax_model(monkeypatch):
    import jax.numpy as jnp

    import yololp_tpu.models as jmodels

    jmodel = jmodels.Model
    monkeypatch.setattr(jmodels, "Model", lambda **kw: jmodel(**{**kw, "dtype": jnp.float32}))


def test_diag_strict_prints_the_jax_report(labelled, fp32_jax_model, capsys):
    from tools import diag_strict as jdiag
    from yololp_tpu_torch.tools import diag_strict

    ckpt, yaml = labelled
    args = ["--ckpt", ckpt, "--data", yaml, "--conf-file", "yololpn", "--img-size", str(IMG),
            "--batch-size", "2", "--workers", "0", "--device", "cpu"]
    (stats, slot_total, slot_right, n_wrong), mats = diag_strict.main(args)
    got = capsys.readouterr().out
    jdiag.main(args)
    want = capsys.readouterr().out
    assert got == want
    # every stage of the funnel is crossed, and the confusions the metric
    # counts are the wrong slots the funnel counts (and more: matched at 0.5)
    assert stats["gt"] > stats["matched50"] > stats["matched70"] > stats["both_ok"] > 0
    assert stats["matched70"] > stats["corner_ok"] and stats["matched70"] > stats["cls_ok"]
    off_diag = sum(int(m.sum() - m.trace()) for m in mats)
    assert off_diag >= int((slot_total - slot_right).sum()) > 0
    assert "top confusion pairs per slot" in got and "pro: " in got


def test_diag_province_prints_the_jax_report(labelled, fp32_jax_model, monkeypatch, capsys):
    import yololp_tpu.core.evaler as jevaler
    import yololp_tpu_torch.core.evaler as tevaler
    from tools import diag_province as jdiag
    from yololp_tpu_torch.tools import diag_province

    # one process: no loader workers (the reports do not depend on them)
    for mod in (jevaler, tevaler):
        load = mod.create_dataloader
        monkeypatch.setattr(mod, "create_dataloader",
                            lambda *a, _load=load, **kw: _load(*a, **{**kw, "workers": 0}))
    ckpt, yaml = labelled
    args = ["--ckpt", ckpt, "--data", yaml, "--conf-file", "yololpn", "--img-size", str(IMG),
            "--batch-size", "2"]
    res = diag_province.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    jdiag.main(args + ["--device", "cpu"])
    assert got == capsys.readouterr().out
    assert sum(n for _, _, n, _, _ in res["buckets"]) == res["gt"] > res["matched"] > 0
    assert sum(res["confusions"].values()) > 0 and "top confusions" in got
    # --max-images cuts the images before the analysis, in both
    diag_province.main(args + ["--device", "cpu", "--max-images", "3"])
    got = capsys.readouterr().out
    jdiag.main(args + ["--device", "cpu", "--max-images", "3"])
    assert got == capsys.readouterr().out


def test_diag_scan_walls_prints_its_keys(capsys):
    from yololp_tpu_torch.tools import diag_scan_walls

    out = diag_scan_walls.main(["--device", "cpu", "--small"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert (out["B"], out["S"], out["C"], out["device"]) == (2, 16, 16, "cpu")
    walls = [k for k in out if k.endswith("_s")]
    assert len(walls) == 1 + 2 * 2 * 7
    for name in ("conv", "empty"):
        for k in (20, 40):
            for w in (["compile_warm"] + [f"same_{i}" for i in range(3)]
                      + [f"freshbuf_{i}" for i in range(3)]):
                assert out[f"{name}_k{k}_{w}_s"] > 0
