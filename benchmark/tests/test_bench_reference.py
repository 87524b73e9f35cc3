"""The benchmark's plain reference against the program, on the CPU at small
sizes: the fold, the fused forward and decode, and the NMS (bit for bit, as
the check holds the served NMS to it). Run: python -m pytest benchmark/tests -q"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference import nms as ref_nms  # noqa: E402
from benchmark.weights import port_config, seeded_state_dict  # noqa: E402

CONFIGS = ("yololps", "yolov6m")


def config(name, img=128):
    return {**json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text()),
            "img_size": img}


@pytest.fixture(scope="module", params=CONFIGS)
def seeded(request):
    from yololp_tpu_torch.layers.fuse import fuse_state_dict
    from yololp_tpu_torch.models.yolo import Model

    cfg = config(request.param)
    sd = seeded_state_dict(cfg, 2**33 + 11, torch.device("cpu"))
    model = Model(port_config(cfg), deploy=True)
    own = {k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    model.load_state_dict({**own, **fuse_state_dict(sd)})
    return cfg, sd, model.eval()


def test_fold_equals_the_program_fusion(seeded):
    from yololp_tpu_torch.layers.fuse import fuse_state_dict

    cfg, sd, _ = seeded
    fused = fuse_state_dict(sd)
    for key in [k for k in fused if k.endswith(".weight") and fused[k].dim() == 4][:40]:
        prefix = key[: -len(".weight")]
        if prefix.endswith("upsample_transpose"):
            continue
        prefix = prefix[: -len(".conv")] if prefix.endswith(".conv") else prefix
        w, b = ref.fold(sd, prefix)
        torch.testing.assert_close(w.float(), fused[key], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b.float(), fused[key[:-len("weight")] + "bias"], rtol=1e-5,
                                   atol=1e-6)


@torch.no_grad()
def test_decode_and_nms_equal_the_program(seeded):
    from yololp_tpu_torch.ops.nms import non_max_suppression

    cfg, sd, model = seeded
    x = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    prog = model(x.permute(0, 3, 1, 2).float() / 255.0)
    dec = ref.decode_images(sd, cfg, x)
    assert dec.shape == prog.shape == (2, 336, 290)
    torch.testing.assert_close(dec, prog, rtol=1e-4, atol=2e-3)

    # the NMS of the same decode: identical rows, order and counts
    _, score = ref_nms.rows_of(prog, cfg["vocab"])
    gate = float(score.sort(1, descending=True).values[:, 200].min())
    out = non_max_suppression(prog, conf_thres=gate, iou_thres=0.45, max_det=300)
    res = ref_nms.nms(prog, cfg["vocab"], gate, 0.45, 300, 512)
    _assert_same_nms(out, res)


def _assert_same_nms(out, res):
    det, valid, num = out
    for i, r in enumerate(res):
        assert int(num[i]) == len(r["idx"]) > 0
        assert torch.equal(det[i][valid[i]], r["rows"])
    assert check.nms_differ(out, res) == 0


@pytest.mark.parametrize("topk,max_det", [(512, 300), (64, 300), (512, 20)])
def test_nms_equals_the_program_on_ties_and_cuts(topk, max_det):
    """Scores on a coarse grid (many exact ties), clustered boxes (IoU near
    the threshold), a top-K and a max_det that cut."""
    from yololp_tpu_torch.ops.nms import non_max_suppression

    g = torch.Generator().manual_seed(5)
    dec = torch.rand(3, 400, 290, generator=g)
    dec[..., 0:2] = (torch.rand(3, 400, 2, generator=g) * 8).round() * 16  # box centres on a grid
    dec[..., 2:4] = 20 + (torch.rand(3, 400, 2, generator=g) * 4).round() * 4
    dec[..., 4] = 1.0
    dec[..., 13:] = (dec[..., 13:] * 4).round() / 4  # confidences in quarters: ties
    vocab = {"npro": 31, "nalp": 24, "nads": 37}
    out = non_max_suppression(dec, conf_thres=0.3, iou_thres=0.45, max_det=max_det,
                              pre_nms_topk=topk)
    res = ref_nms.nms(dec, vocab, 0.3, 0.45, max_det, topk)
    _assert_same_nms(out, res)


def test_nms_differ_counts_what_differs():
    rows = torch.rand(2, 5, 28)
    det = torch.zeros(2, 6, 28)
    det[:, :5] = rows
    valid = torch.zeros(2, 6, dtype=torch.bool)
    valid[:, :5] = True
    num = torch.tensor([5, 5], dtype=torch.int32)
    res = [dict(rows=rows[0]), dict(rows=rows[1])]
    assert check.nms_differ((det, valid, num), res) == 0
    tied = rows.clone()
    tied[:, :, 12:20] = 0.5  # every score equal: any order is the same answer
    det2 = det.clone()
    det2[:, :5] = tied.flip(1)
    assert check.nms_differ((det2, valid, num), [dict(rows=tied[0]), dict(rows=tied[1])]) == 0
    assert check.nms_differ((det, valid, torch.tensor([5, 4], dtype=torch.int32)), res) == 1
    det3 = det.clone()
    det3[1, 2, 0] += 1e-3
    assert check.nms_differ((det3, valid, num), res) == 1
    assert check.nms_differ((det, valid, num), [dict(rows=rows[0][:4]), dict(rows=rows[1])]) == 1


def test_fp8_control_rounds_to_three_mantissa_bits():
    t = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.3])
    out = ref.fp8_round(t)
    assert out[1] in (1.0, 1.125) and out[2] == 1.125 and out[3] == 448.0
    assert abs(float(out[4]) + 3.3) <= 3.3 / 8


def test_bf16_base_rounds_to_eight_mantissa_bits():
    t = torch.tensor([1.0 + 2**-9, 1.0 + 2**-7, -3.3])
    out = ref.bf16_round(t)
    assert out[0] == 1.0 and out[1] == 1.0 + 2**-7 and out.dtype == torch.float32
    assert abs(float(out[2]) + 3.3) <= 3.3 / 256
