"""YOLOv6-L6's plain reference (benchmark/reference/p6.py) and its harness
path, on the CPU, and the Inferer's input size for the P6 heads.

The graph is yolov6l6's (conv_silu, CSPBepBackbone_P6 with fused P2,
CSPRepBiFPANNeck_P6, the 4-level DFL head) at yolov6n6's multipliers (depth
0.33, width 0.25), on weights seeded as the benchmark seeds them
(benchmark/weights_p6.py), at 128 px:
- each reference unit (conv_silu block, BottleRep, BepC3, ReLU SPPF, reduce
  layer, BiFusion, downsample) equals the program's deploy module on the
  input that module saw, and every folded conv equals layers/fuse.py's;
- the program's fp32 deploy decode equals the reference's within a stated
  tolerance that the reference computed with bf16-rounded convs fails;
- the program's NMS on that decode equals reference/nms.py bit for bit;
- benchmark/flops/p6.py equals torch.utils.flop_counter on the program's
  deploy graph at 1280 and published widths (668.35 GFLOPs), on the meta
  device;
- the benchmark's cell runs through `run.run_cell` at a small size and reads
  correct, with the NMS exact; and reads not correct when the program's
  images are permuted or copied within a batch, at its entry or its output;
- the reference loads nothing of the program, and neither it nor the driver
  anything of JAX or the JAX package.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from yololp_tpu_torch.core import inferer
from yololp_tpu_torch.core.inferer import Inferer
from yololp_tpu_torch.layers.fuse import fuse_state_dict
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.ops.nms import non_max_suppression

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import check, run, spec as S  # noqa: E402
from benchmark.flops.p6 import forward_flops  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference import nms as ref_nms  # noqa: E402
from benchmark.reference import p6  # noqa: E402
from benchmark.weights import port_config  # noqa: E402
from benchmark.weights_p6 import seeded_state_dict  # noqa: E402

torch.set_num_threads(2)

CELL = "yolov6l6-b32-1280-dense"
SPEC = S.load(ROOT)
# The program folds each BN in fp32, the reference in float64 then rounds;
# their conv sums run in other orders. So the decodes differ by rounding
# that grows through the graph: measured at most 9.8e-4 px (8 ulps of fp32
# at the 1024-2048 px that the stride-64 DFL boxes reach) and 1.0e-6 in a
# score over three seeds. The limits leave 3x room above that in a
# coordinate (2e-3 px + 1e-6 of up to 1300 px) and 20x in a score; the
# reference with bf16-rounded conv inputs and weights misses them by 1000x
# (4-5 px, 8e-3 in a score).
COORD_TOL = dict(rtol=1e-6, atol=2e-3)  # columns 0:13, pixels
SCORE_TOL = dict(rtol=0.0, atol=2e-5)  # columns 13:, sigmoids


def narrow(img=128):
    """yolov6l6's configuration at yolov6n6's multipliers and `img` px."""
    cfg = json.loads(json.dumps(S.config(SPEC, "yolov6l6", ROOT)))
    cfg["model"].update(depth_multiple=0.33, width_multiple=0.25)
    return {**cfg, "img_size": img}


@pytest.fixture(scope="module")
def seeded():
    cfg = narrow()
    sd = seeded_state_dict(cfg, 2**33 + 19, torch.device("cpu"))
    model = Model(port_config(cfg), deploy=True)
    own = {k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    model.load_state_dict({**own, **fuse_state_dict(sd)})
    return cfg, sd, model.eval()


@pytest.fixture(scope="module")
def decodes(seeded):
    """The program's fp32 deploy decode of two seeded frames and the
    reference's, in fp32 and with bf16-rounded convs."""
    cfg, sd, model = seeded
    x = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        prog = model(x.permute(0, 3, 1, 2).float() / 255.0)
    return prog, p6.decode_images(sd, cfg, x), p6.decode_images(sd, cfg, x, "bf16")


def close(a, b, coords, scores):
    torch.testing.assert_close(a[..., :13], b[..., :13], **coords)
    torch.testing.assert_close(a[..., 13:], b[..., 13:], **scores)


# -- the units --------------------------------------------------------------

def _c(cfg, i):
    return ref.scaled_lists(cfg["model"])[1][i]


def _n(cfg, i):
    return ref.scaled_lists(cfg["model"])[0][i]


E = 0.5  # csp_e of the backbone and the neck
UNITS = {  # the program's module -> the reference's computation of it on that module's input
    "backbone.stem": lambda P, x, cfg: p6.unit(P, x, "backbone.stem", _c(cfg, 0), 2),
    "backbone.ERBlock_2_down": lambda P, x, cfg: p6.unit(P, x, "backbone.ERBlock_2_down",
                                                         _c(cfg, 1), 2),
    "backbone.ERBlock_4_csp.m.block_0": lambda P, x, cfg: p6.bottlerep(
        P, x, "backbone.ERBlock_4_csp.m.block_0", _c(cfg, 3) // 2),
    "backbone.ERBlock_4_csp": lambda P, x, cfg: p6.bepc3(P, x, "backbone.ERBlock_4_csp",
                                                         _c(cfg, 3), _n(cfg, 3), E),
    "backbone.ERBlock_6_down": lambda P, x, cfg: p6.unit(P, x, "backbone.ERBlock_6_down",
                                                         _c(cfg, 5), 2),
    "backbone.ERBlock_6_sppf": lambda P, x, cfg: ref.sppf(P, x, "backbone.ERBlock_6_sppf",
                                                          _c(cfg, 5)),
    "neck.reduce_layer0": lambda P, x, cfg: ref.cba(P, x, "neck.reduce_layer0", _c(cfg, 6), 1),
    "neck.Bifusion2": lambda P, x, cfg: ref.bifusion(P, *x, "neck.Bifusion2", _c(cfg, 8)),
    "neck.Rep_p5": lambda P, x, cfg: p6.bepc3(P, x, "neck.Rep_p5", _c(cfg, 6), _n(cfg, 6), E),
    "neck.downsample0": lambda P, x, cfg: ref.cba(P, x, "neck.downsample0", x.shape[1], 3, 2),
    "neck.Rep_n6": lambda P, x, cfg: p6.bepc3(P, x, "neck.Rep_n6", _c(cfg, 11), _n(cfg, 11), E),
}


@pytest.fixture(scope="module")
def unit_io(seeded):
    """Each UNITS module's input and output in one program forward."""
    _, _, model = seeded
    seen, hooks = {}, []
    for name in UNITS:
        mod = model.get_submodule(name)
        hooks.append(mod.register_forward_hook(
            lambda m, args, out, name=name: seen.__setitem__(name, (args[0], out))))
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(4))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.mark.parametrize("name", sorted(UNITS))
def test_each_reference_unit_equals_the_programs_module(name, seeded, unit_io):
    cfg, sd, _ = seeded
    x, want = unit_io[name]
    with torch.no_grad():
        got = UNITS[name](ref.Fused(sd), x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_every_folded_conv_equals_the_program_fusion(seeded):
    _, sd, _ = seeded
    fused = fuse_state_dict(sd)
    keys = [k for k in fused if k.endswith(".weight") and fused[k].dim() == 4
            and "upsample_transpose" not in k]
    # the conv_silu units: the stem, 5 down blocks, 2 in each of the 8 + 12 BottleReps
    assert sum(".block.conv." in k for k in keys) == 1 + 5 + 2 * (8 + 12)
    for key in keys:
        prefix = key[: -len(".weight")]
        w, b = ref.fold(sd, prefix[: -len(".conv")] if prefix.endswith(".conv") else prefix)
        torch.testing.assert_close(w.float(), fused[key], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b.float(), fused[prefix + ".bias"], rtol=1e-5, atol=1e-6)


def test_the_reference_refuses_another_graph():
    cfg = narrow()
    for section, key, value in [("backbone", "type", "CSPBepBackbone"),
                                ("neck", "type", "CSPRepPANNeck_P6"),
                                ("head", "num_layers", 3)]:
        bad = json.loads(json.dumps(cfg))
        bad["model"][section][key] = value
        with pytest.raises(ValueError):
            p6.model_of(bad)
    with pytest.raises(ValueError):
        p6.model_of({**cfg, "training_mode": "repvgg"})


# -- decode, NMS, FLOPs -------------------------------------------------------

def test_the_program_decode_equals_the_reference(decodes):
    prog, dec, bf16 = decodes
    assert prog.shape == dec.shape == (2, 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2, 290)
    close(dec, prog, COORD_TOL, SCORE_TOL)
    with pytest.raises(AssertionError):  # the limits separate fp32 from bf16
        close(bf16, prog, COORD_TOL, SCORE_TOL)


def test_the_nms_on_that_decode_equals_the_reference(seeded, decodes):
    cfg, _, _ = seeded
    prog = decodes[0]
    _, score = ref_nms.rows_of(prog, cfg["vocab"])
    gate = float(score.sort(1, descending=True).values[:, 200].min())
    out = non_max_suppression(prog, conf_thres=gate, iou_thres=0.45, max_det=300)
    res = ref_nms.nms(prog, cfg["vocab"], gate, 0.45, 300, 512)
    det, valid, num = out
    for i, r in enumerate(res):
        assert int(num[i]) == len(r["idx"]) > 0
        assert torch.equal(det[i][valid[i]], r["rows"])
    assert check.nms_differ(out, res) == 0


def test_flops_equal_the_flop_counter_on_the_program_at_1280():
    cfg = S.config(SPEC, "yolov6l6", ROOT)
    with torch.device("meta"):
        model = Model(port_config(cfg), deploy=True).eval()
        x = torch.empty(1, 3, 1280, 1280)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model.detect.pred_maps(model.neck(model.backbone(x)))
    conv = sum(v for k, v in fc.get_flop_counts()["Global"].items() if "convolution" in str(k))
    assert forward_flops(cfg, 1280, 1280) == conv == 668_348_416_000
    # YOLOv6-L6 is published at 673.4 GFLOPs with COCO's head
    assert sum(p.numel() for p in model.parameters()) == 140_753_728


def test_flops_equal_the_flop_counter_on_the_reference(seeded):
    cfg, sd, _ = seeded
    x = torch.zeros((1, 128, 192, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        p6.decode_images(sd, cfg, x)
    conv = sum(v for k, v in fc.get_flop_counts()["Global"].items() if "convolution" in str(k))
    assert forward_flops(cfg, 128, 192) == conv > 0


# -- the harness path ---------------------------------------------------------

SMALL = {"config": {"img_size": 128, "model": narrow()["model"]},
         "traffic": {"batch": 2, "frame": [128, 128], "pool": 2, "trace_iters": 2,
                     "warmup_rounds": 1}}


def test_the_cell_runs_correct_at_a_small_size(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    r = run.run_cell(SPEC, CELL, 2**31 + 19, 0.3, True, torch.device("cpu"),
                     time.perf_counter(), SMALL)
    assert r["correct"] and r["checks"]["nms_images_differ"]["value"] == 0
    assert r["checks"]["box_err_ratio"]["value"] <= r["checks"]["box_err_ratio"]["limit"]
    assert r["metrics"]["decode_anchors.serve"]["value"] == 340.0
    assert r["metrics"]["conv_epilogue_fused.serve"]["value"] == 100.0
    assert "p6_ms.serve" not in r["metrics"]  # spans time no device on the CPU


UNIT_PIXELS, NMS = inferer.unit_pixels, inferer.non_max_suppression  # as the program has them


def _entry(fault):
    def unit_pixels(x, dtype):
        y = UNIT_PIXELS(x, dtype)
        return y.roll(1, 0) if fault == "roll" else y[[0] * y.shape[0]]
    return unit_pixels


def _output(*args, **kwargs):
    return tuple(o.roll(1, 0) for o in NMS(*args, **kwargs))


@pytest.mark.parametrize("where, fault", [
    ("entry", "roll"), ("entry", "copy"), ("output", "roll"),
])
def test_the_cell_reads_images_swapped_within_a_batch_not_correct(where, fault, monkeypatch):
    """A program that serves each image another image's detections: its
    batch rolled by one, or its first image copied over the rest, before the
    forward (seen by the forward's check: the NMS stage runs on the same
    faulty decode) or after the NMS (seen by the NMS stage's)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    if where == "entry":
        monkeypatch.setattr("yololp_tpu_torch.core.inferer.unit_pixels", _entry(fault))
    else:
        monkeypatch.setattr("yololp_tpu_torch.core.inferer.non_max_suppression", _output)
    r = run.run_cell(SPEC, CELL, 2**31 + 19, 0.3, False, torch.device("cpu"),
                     time.perf_counter(), SMALL)
    ratio = r["checks"]["box_err_ratio"]
    assert not r["correct"]
    if where == "entry":
        assert r["checks"]["nms_images_differ"]["value"] == 0
        assert ratio["value"] > 2 * ratio["limit"]
    else:
        assert r["checks"]["nms_images_differ"]["value"] == 2 * SMALL["traffic"]["pool"]


def test_the_reference_and_the_driver_load_no_jax_side_module():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "top = lambda: sorted({m.split('.')[0] for m in sys.modules})\n"
        "import benchmark.reference.p6\n"
        "ref = top()\n"
        "import benchmark.kinds.serve_p6, benchmark.flops.p6, benchmark.weights_p6\n"
        "print(json.dumps([ref, top()]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    ref_mods, all_mods = json.loads(p.stdout.strip().splitlines()[-1])
    jax_side = {"jax", "jaxlib", "flax", "yololp_tpu"}
    assert "benchmark" in ref_mods and not set(ref_mods) & (jax_side | {"yololp_tpu_torch"})
    assert not set(all_mods) & jax_side


# -- the Inferer's input size -------------------------------------------------

@pytest.mark.parametrize("name, asked, served", [
    ("yolov6n6", 1248, 1280), ("yolov6n6", 96, 128), ("yolov6n6", 128, 128),
    ("yololpn", 96, 96), ("yololpn", 100, 128), ("yololpn", 640, 640),
])
def test_the_input_size_is_a_multiple_of_the_deepest_stride(name, asked, served):
    inf = Inferer(None, None, name, img_size=asked, half=False, device="cpu")
    assert inf.img_size == [served, served]
    assert max(inf.model.detect.strides) == (64 if name.endswith("6") else 32)


def test_a_p6_inferer_asked_for_96_serves_128_and_runs():
    inf = Inferer(None, None, "yolov6n6", img_size=96, half=False, conf_thres=0.0, max_det=5,
                  device="cpu")
    batch = np.random.default_rng(0).integers(0, 255, (1, *inf.img_size, 3), np.uint8)
    det, valid, num = inf._run(batch)
    assert det.shape == (1, 5, 28) and 0 < int(num[0]) <= 5
    assert inf.predict(batch).shape == (1, 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2, 290)
