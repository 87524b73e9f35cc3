"""The NMS gate op, `yololp_torch::nms_gate` (yololp_tpu_torch/ops/cuda_nms_gate.py),
and its call site `ops/nms.py:select_candidates`, on the CPU.

The op is held bit for bit to the sequence select_candidates ran before it
(`legacy_gate`, kept here): xywh2xyxy, cls * obj, 8 amax and 8 argmax
reductions, the left-to-right sum of the maxima over 8, the gate, and the
`rest` concat the top-K gathers from. Cases: random decodes at 8400 and
34000 anchors, exact ties inside a task (the first index wins), NaN rows
(NaN is the maximum, the first NaN the argmax), scores at fp32(conf_thres)
and its two fp32 neighbours with a representable threshold and with ones
that fp32 rounds up (0.4) and down (0.7), compat_ad4_bug on and off.
Besides: the fake's shapes, dtypes and strides, opcheck, refusals, the
plain sequence for float64 and strided input on the CPU and the op for
every decode on the card (a fake CUDA tensor), the counters and the
benchmark's reader of them, a `.pt2` holding one `nms_gate` node and the
AOTInductor program holding none."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from yololp_tpu_torch.export.export import inductor_program
from yololp_tpu_torch.ops import cuda_nms_gate
from yololp_tpu_torch.ops.geometry import xywh2xyxy
from yololp_tpu_torch.ops.nms import non_max_suppression, select_candidates
from yololp_tpu_torch.utils import profiler as P

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import spec as S  # noqa: E402

torch.set_num_threads(2)
TASKS = [(0, 31), (31, 24)] + [(55 + 37 * i, 37) for i in range(6)]  # (first score col, width)


@pytest.fixture(autouse=True)
def empty_store():
    P.reset_spans()
    yield
    P.reset_spans()


def legacy_gate(prediction, conf_thres, compat_ad4_bug):
    """The gate as select_candidates ran it before the op, and the `rest`
    its top-K step concatenated."""
    box = xywh2xyxy(prediction[..., :4])
    obj = prediction[..., 4:5]
    cls = prediction[..., 13:] * obj
    task_scores = [cls[..., s:s + w] for s, w in TASKS]
    confs = torch.stack([t.amax(dim=-1) for t in task_scores], -1)
    preds = torch.stack([t.argmax(dim=-1) for t in task_scores], -1)

    def total(cols):
        out = confs[..., cols[0]]
        for c in cols[1:]:
            out = out + confs[..., c]
        return out

    score = total(range(8)) / 8.0
    mask_conf = total((0, 1, 2, 3, 4, 5, 6, 6)) / 8.0 if compat_ad4_bug else score
    passed = mask_conf >= conf_thres
    gated = torch.where(passed, score, torch.zeros_like(score))
    rest = torch.cat([prediction[..., 5:13], confs, preds.float()], -1)
    return box, gated, rest, passed


def decode(b, a, seed, obj_one=True):
    """A (b, a, 290) fp32 decode: boxes in pixels, obj 1 (or in (0, 1]),
    corners, sigmoid scores."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, a, 2, generator=g) * 640
    wh = torch.rand(b, a, 2, generator=g) * 100 + 1
    obj = torch.ones(b, a, 1) if obj_one else torch.rand(b, a, 1, generator=g) * 0.999 + 0.001
    corners = torch.rand(b, a, 8, generator=g) * 640
    cls = torch.sigmoid(torch.randn(b, a, 277, generator=g) * 3 - 2)
    return torch.cat([xy, wh, obj, corners, cls], -1).contiguous()


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want):
    for name, g, w in zip(("box", "score", "rest", "passed"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(bits(g), bits(w)), name


def gate_both(pred, thres, compat):
    got = cuda_nms_gate.nms_gate(pred, thres, compat)
    assert_same(got, legacy_gate(pred, thres, compat))
    return got


@pytest.mark.parametrize("compat", [False, True], ids=["mean", "ad4_bug"])
@pytest.mark.parametrize("b, a, obj_one", [(2, 8400, True), (1, 34000, True), (3, 517, False)])
def test_random_decodes(b, a, obj_one, compat):
    pred = decode(b, a, seed=a + b, obj_one=obj_one)
    median = float(legacy_gate(pred, 0.0, False)[1].median())
    for thres in (0.0, 0.4, median):
        _, _, _, passed = gate_both(pred, thres, compat)
    assert 0 < int(passed.sum()) < b * a


def test_ties_within_a_task_take_the_first_index():
    pred = decode(1, 64, seed=3)
    g = torch.Generator().manual_seed(4)
    for row in range(64):
        for k, (s, w) in enumerate(TASKS):
            at = torch.randperm(w, generator=g)[: 2 + (row + k) % 3]  # 2..4 equal maxima
            pred[0, row, 13 + s + at] = 0.9 - 0.001 * k
    pred[0, :8, 13:] = 0.25  # whole rows of one value: every task's argmax is 0
    _, _, rest, _ = gate_both(pred, 0.3, False)
    assert (rest[0, :8, 16:] == 0).all()
    ids = rest[0, 8:, 16:].long()
    for k, (s, w) in enumerate(TASKS):
        vals = pred[0, 8:, 13 + s:13 + s + w]
        first = (vals == vals.amax(-1, keepdim=True)).float().argmax(-1)
        assert torch.equal(ids[:, k], first)


def test_nan_rows():
    pred = decode(2, 40, seed=5)
    nan = float("nan")
    pred[0, 0, 13 + 31 + 5] = nan              # alphabet: one NaN
    pred[0, 1, [13 + 2, 13 + 9]] = nan          # province: two, the first wins
    pred[0, 2, 4] = nan                         # obj: every score NaN, argmax 0
    pred[0, 3, 13:] = nan                       # all scores
    pred[0, 4, 0] = nan                         # a box coordinate only
    pred[1, 7, 13 + 55 + 37 * 5 + 36] = nan     # the last column of the last task
    box, score, rest, passed = gate_both(pred, 0.1, False)
    assert rest[0, 0, 17] == 5 and rest[0, 1, 16] == 2 and (rest[0, 2, 16:] == 0).all()
    assert not passed[0, :4].any() and (score[0, :4] == 0).all()
    assert torch.isnan(box[0, 4, [0, 2]]).all() and rest[1, 7, 23] == 36
    gate_both(pred, 0.1, True)


@pytest.mark.parametrize("thres", [0.4, 0.7, 0.25, 0.3],
                         ids=["rounds-up", "rounds-down", "exact", "rounds-up-2"])
@pytest.mark.parametrize("compat", [False, True], ids=["mean", "ad4_bug"])
def test_scores_at_the_threshold_and_its_neighbours(thres, compat):
    """Rows whose score is v exactly, for v fp32(thres) and its two fp32
    neighbours: task maxima (v, v, 2v, 0, 4v, 0, 0, 0), whose partial sums
    are exact in either gate."""
    t32 = np.float32(thres)
    vals = [np.nextafter(t32, np.float32(0)), t32, np.nextafter(t32, np.float32(1))]
    pred = decode(1, 3 * 8, seed=6)
    for i, v in enumerate(vals):
        for j in range(8):
            row = pred[0, 8 * i + j]
            row[13:] = 0.0
            for (s, w), scale in zip(TASKS, (1, 1, 2, 0, 4, 0, 0, 0)):
                row[13 + s + (j * 5) % w] = float(v) * scale
    _, score, _, passed = gate_both(pred, thres, compat)
    want = [float(v) >= thres for v in vals]  # fp32 v against the double threshold
    got = passed[0].view(3, 8)
    assert (got[0] == False).all() and (got[2] == True).all()  # noqa: E712
    assert bool(got[1].all()) == bool(np.float32(vals[1]) >= np.float32(thres))
    assert want[0] is False and want[2] is True
    assert torch.equal(score[0].view(3, 8)[1], torch.full((8,), float(t32)))


def test_fake_gives_shapes_dtypes_and_strides():
    with FakeTensorMode():
        pred = torch.empty(3, 100, 290)
        box, score, rest, passed = torch.ops.yololp_torch.nms_gate(pred, 0.4, False)
    assert (box.shape, score.shape, rest.shape, passed.shape) == (
        (3, 100, 4), (3, 100), (3, 100, 24), (3, 100))
    assert [t.dtype for t in (box, score, rest, passed)] == [torch.float32] * 3 + [torch.bool]
    assert all(t.is_contiguous() for t in (box, score, rest, passed))
    real = cuda_nms_gate.nms_gate(decode(3, 100, seed=0), 0.4)
    assert [t.stride() for t in real] == [(400, 4, 1), (100, 1), (2400, 24, 1), (100, 1)]


@pytest.mark.parametrize("compat", [False, True])
def test_opcheck(compat):
    result = torch.library.opcheck(torch.ops.yololp_torch.nms_gate.default,
                                   (decode(2, 37, seed=1), 0.2, compat))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("bad, err, match", [
    (lambda p: p.double(), TypeError, "float32"),
    (lambda p: p[..., :289], ValueError, "290"),
    (lambda p: p.transpose(0, 1), ValueError, "contiguous"),
    (lambda p: p[0], ValueError, "290"),
])
def test_refusals_raise(bad, err, match):
    with pytest.raises(err, match=match):
        cuda_nms_gate.nms_gate(bad(decode(2, 5, seed=0)), 0.4)


def counted(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    c = P.counters()
    P.reset_spans()
    return out, c


@pytest.mark.parametrize("kind", ["float64", "strided"])
def test_other_inputs_take_the_plain_sequence(kind):
    pred = decode(2, 300, seed=8)
    if kind == "float64":
        other = pred.double()
    else:
        other = torch.stack([pred, pred], 2).view(2, 600, 290)[:, ::2]
        assert not other.is_contiguous() and torch.equal(other, pred)
    (box, score, rest), c = counted(lambda: select_candidates(other, 0.2, 64))
    assert c["nms.gate_calls"] == 1 and "nms.gate_fused" not in c
    lbox, lscore, lrest, _ = legacy_gate(other, 0.2, False)
    top, idx = torch.sort(lscore, dim=1, descending=True, stable=True)
    assert torch.equal(score, top[:, :64].contiguous())
    assert torch.equal(box, torch.gather(lbox, 1, idx[:, :64, None].expand(-1, -1, 4)))
    assert torch.equal(rest, torch.gather(lrest, 1, idx[:, :64, None].expand(-1, -1, 24)))
    assert rest.dtype == other.dtype
    # and the fp32 contiguous decode takes the op, to the same candidates
    (fbox, fscore, frest), c = counted(lambda: select_candidates(pred, 0.2, 64))
    assert c["nms.gate_calls"] == c["nms.gate_fused"] == 1
    if kind == "strided":
        assert torch.equal(fbox, box) and torch.equal(fscore, score) and torch.equal(frest, rest)


@pytest.mark.parametrize("kind, err, match", [
    ("float64", TypeError, "float32"),
    ("strided", ValueError, "contiguous"),
])
def test_a_card_decode_always_takes_the_op(kind, err, match):
    """On the card no decode falls back to the plain sequence: one the kernel
    does not take reaches the op and raises (a fake CUDA tensor here, which
    reaches the op's fake; it checks as the kernel's wrapper does)."""
    with FakeTensorMode():
        pred = torch.empty(2, 300, 290, device="cuda")
        box, score, rest, passed = cuda_nms_gate.nms_gate(pred, 0.2)
        assert [t.shape for t in (box, score, rest, passed)] == [(2, 300, 4), (2, 300),
                                                                 (2, 300, 24), (2, 300)]
        assert box.device.type == "cuda"
        if kind == "float64":
            other = pred.double()
        else:
            other = torch.empty_strided((2, 300, 290), (600 * 290, 2 * 290, 1), device="cuda")
        with pytest.raises(err, match=match):
            select_candidates(other, 0.2, 64)


def test_counters_and_the_reader():
    assert S.reader("nms_gate_fused.serve")({}) is None
    pred = decode(2, 200, seed=9)
    (_, c) = counted(lambda: non_max_suppression(pred, conf_thres=0.2, max_det=10))
    assert c["nms.gate_calls"] == c["nms.gate_fused"] == 1
    assert c["nms.slots"] == 2 * 200 and c["nms.gated"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        non_max_suppression(pred, conf_thres=0.2, max_det=10)
        non_max_suppression(pred.double(), conf_thres=0.2, max_det=10)
        non_max_suppression(pred, conf_thres=0.2, max_det=10)
        non_max_suppression(pred, conf_thres=0.2, max_det=10)
    assert S.reader("nms_gate_fused.serve")({}) == 75.0
    m = {x["name"]: x for x in S.load(ROOT)["per_layer"]}["nms_gate_fused.serve"]
    assert (m["source"], m["layer"], m["moves"], m["unit"], m["better"]) == (
        "program_counter", "NMS stage", "images_per_s", "%", "higher")
    assert m["workloads"] == ["yololps-b128-dense", "yolov6m-b128-dense",
                              "yolov6l6-b32-1280-dense", "yololps-b128-int8-dense"]


class _NMS(torch.nn.Module):
    def forward(self, pred):
        return non_max_suppression(pred, conf_thres=0.2, iou_thres=0.45, max_det=20,
                                   pre_nms_topk=64)


def _targets(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def test_a_pt2_holds_one_gate_and_the_aoti_program_none(tmp_path):
    pred = decode(2, 300, seed=10)
    with torch.no_grad():
        program = torch.export.export(_NMS(), (pred,))
    path = str(tmp_path / "nms.pt2")
    torch.export.save(program, path)
    loaded = torch.export.load(path)
    assert _targets(loaded).count("yololp_torch.nms_gate.default") == 1
    assert not [t for t in _targets(loaded) if "amax" in t or "argmax" in t]
    want = _NMS()(pred)
    with torch.no_grad():
        got = loaded.module()(pred)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    decomposed = inductor_program(program)
    targets = _targets(decomposed)
    assert not [t for t in targets if "nms_gate" in t]
    assert targets.count("yololp_torch.greedy_nms_mask.default") == 1
    assert [t for t in targets if "argmax" in t]
    with torch.no_grad():
        got = decomposed.module()(pred)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
