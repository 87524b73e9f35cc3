"""The benchmark's counts: the fused forward's conv FLOPs against
torch.utils.flop_counter on the reference at batch 1, and the greedy-NMS
operations and bytes on a case worked by hand."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.flops.model import forward_flops  # noqa: E402
from benchmark.flops.nms import AREA_OPS, BYTES_PER_BOX, IOU_PAIR_OPS, nms_work  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference import nms as ref_nms  # noqa: E402
from benchmark.weights import seeded_state_dict  # noqa: E402


def config(name, img):
    return {**json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text()),
            "img_size": img}


@pytest.mark.parametrize("name", ["yololps", "yolov6m"])
def test_forward_flops_equal_the_flop_counter(name):
    cfg = config(name, 96)
    sd = seeded_state_dict(cfg, 5, torch.device("cpu"))
    x = torch.zeros((1, 96, 128, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        ref.decode_images(sd, cfg, x)
    conv = sum(v for k, v in fc.get_flop_counts()["Global"].items() if "convolution" in str(k))
    assert forward_flops(cfg, 96, 128) == conv > 0


def test_forward_flops_at_640_are_the_published_scale():
    # YOLOv6-S is published at 45.3 GFLOPs and YOLOv6-M at 85.8 with COCO's
    # head; the LP head's 277 class columns change the head's share only
    assert 44e9 < forward_flops(config("yololps", 640), 640, 640) < 47e9
    assert 84e9 < forward_flops(config("yolov6m", 640), 640, 640) < 88e9


def test_nms_work_by_hand():
    # K = 4: boxes 0 and 2 kept, 3 valid candidates; box 0 is tested against
    # 1 and 2, box 2 against none (3 is not valid)
    ops, nbytes = nms_work([[True, False, True, False]], [3])
    assert ops == 4 * AREA_OPS + 2 * IOU_PAIR_OPS
    assert nbytes == 4 * BYTES_PER_BOX == 84
    ops2, nbytes2 = nms_work([[True] * 3, [False] * 3], [3, 0])
    assert ops2 == 6 * AREA_OPS + (2 + 1) * IOU_PAIR_OPS and nbytes2 == 6 * 21


def test_reference_nms_keeps_what_a_hand_walk_keeps():
    # three candidates: 1 overlaps 0 (IoU 0.6 > 0.45), 2 is apart
    dec = torch.zeros(1, 3, 290)
    dec[0, :, :4] = torch.tensor([[10., 10, 10, 10], [11., 10, 10, 10], [50., 50, 10, 10]])
    dec[0, :, 4] = 1
    dec[0, :, 13:] = torch.tensor([0.9, 0.8, 0.7])[:, None]
    r = ref_nms.nms(dec, {"npro": 31, "nalp": 24, "nads": 37}, 0.1, 0.45, 300, 512)[0]
    assert r["idx"].tolist() == [0, 2] and r["keep"] == [True, False, True] and r["n_valid"] == 3
