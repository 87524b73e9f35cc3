"""The check's control and its faults, on the CPU at a size a test run can
hold (the cells' widths and depths, 128-pixel frames, 2-image batches).

- The control: the reference computed with fp8 inputs and weights in every
  conv, put in the program's place, reads `correct` false under each cell's
  limits.
- The faults: a whole run (the look for a card skipped) with the timed path
  broken underneath reads `correct` false: half of each batch answered
  with nothing; one image's answer altered where it is produced (its boxes
  shifted by a stride, its confidences raised); and in the NMS stage, the
  keep mask set all true, the suppression skipped (every gated candidate
  kept), the suppression inverted, the top-K halved, max_det cut to 9.
- The sound program at this size reads `correct` true.
"""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, run, spec as S  # noqa: E402
from test_bench_harness import CELLS, SPEC, small  # noqa: E402


@pytest.fixture(autouse=True)
def no_cuda_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def driver(cell, seed):
    ov, c = small(cell), S.cell(SPEC, cell)
    cfg = {**S.config(SPEC, c["config"]), **ov["config"]}
    tr = {**S.traffic(c["traffic"]), **ov["traffic"]}
    d = S.kind(tr["kind"]).Driver(cfg, tr, seed, torch.device("cpu"), lambda m: None)
    d.setup(False)
    return d


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    d = driver(cell, 2**32 + 21)
    numbers = d.control()
    # the control's NMS stage is the reference's own, so it is judged on the forward's numbers
    limits = {k: v for k, v in S.limits(cell).items() if k != "nms_images_differ"}
    assert set(limits) <= set(numbers)
    ok, checks = check.judge(numbers, limits)
    assert not ok, checks


def _break(monkeypatch, how):
    from yololp_tpu_torch.core import inferer
    from yololp_tpu_torch.ops import nms

    Inferer = inferer.Inferer
    if how in ("half_left_out", "answer_altered"):
        sound = Inferer._run

        def broken(self, images):
            det, valid, num = (o.clone() for o in sound(self, images))
            if how == "half_left_out":
                half = det.shape[0] // 2
                valid[half:] = False
                num[half:] = 0
                det[half:] = 0
            else:  # one image's answer altered where it is produced
                det[0, :, :12] += 8.0
                det[0, :, 12:20] += 0.05
            return det, valid, num

        monkeypatch.setattr(Inferer, "_run", broken)
    elif how in ("keep_all_mask", "suppression_skipped", "suppression_inverted"):
        sound_mask = nms.greedy_nms_mask

        def mask(boxes, scores, iou_thres, iters=0):
            if how == "keep_all_mask":
                return torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
            if how == "suppression_skipped":
                return scores > 0
            return (scores > 0) & ~sound_mask(boxes, scores, iou_thres, iters=iters)

        monkeypatch.setattr(nms, "greedy_nms_mask", mask)
    else:  # the top-K halved or max_det cut where _run calls the NMS
        sound_nms = nms.non_max_suppression

        def cut(prediction, **kw):
            if how == "topk_halved":
                kw["pre_nms_topk"] = min(512, prediction.shape[1]) // 2
            else:
                kw["max_det"] = kw["max_det"] // 32  # under what either model keeps
            return sound_nms(prediction, **kw)

        monkeypatch.setattr(inferer, "non_max_suppression", cut)


FAULTS = ["half_left_out", "answer_altered", "keep_all_mask", "suppression_skipped",
          "suppression_inverted", "topk_halved", "max_det_cut"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("how", FAULTS)
def test_a_broken_timed_path_reads_incorrect(cell, how, monkeypatch):
    _break(monkeypatch, how)
    r = run.run_cell(SPEC, cell, 2**31 + 5, 0.3, False, torch.device("cpu"), time.perf_counter(),
                     small(cell))
    assert r["correct"] is False, r["checks"]
    if how in FAULTS[2:]:  # a fault of the NMS stage shows in its own number
        assert r["checks"]["nms_images_differ"]["value"] > 0, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_reads_correct(cell):
    r = run.run_cell(SPEC, cell, 2**31 + 5, 0.3, False, torch.device("cpu"), time.perf_counter(),
                     small(cell))
    assert r["correct"] is True, r["checks"]
