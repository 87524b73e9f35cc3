"""The port's spans and counters (yololp_tpu_torch/utils/profiler.py:
`annotate`, `count`) on the CPU, at tiny shapes: nothing records with the
profiler off; under torch.profiler `Inferer._run` records each span of the
served path once, nested by parent and request ids, inside the profiler's
own ranges (one clock); the NMS counters read exactly; the outputs are the
same bits recording or not; the benchmark's readers of the spans and
counters read a filled store and nothing from an empty one; a P6 model
records its three stride-64 spans, nested in the model's, where a P5 model
records none, and both count B x A decoded anchors; an exported graph holds
no profiler op; threads recording at once keep their own requests; an
Inferer serving its int8 plan records the same spans, with `int8.quantize`
inside the model's, and counts its int8 conv launches. A card is stood in
for by fake CUDA events where a device time is needed. And the inferer's FPS
is images over seconds."""

import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from yololp_tpu_torch.core.inferer import CalcFPS, Inferer
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.utils import profiler as P

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import spec as S  # noqa: E402

torch.set_num_threads(2)

SERVED = {  # span -> its parent's span
    "infer.run": None, "infer.entry": "infer.run", "model.backbone": "infer.run",
    "model.neck": "infer.run", "model.head": "infer.run", "model.decode": "infer.run",
    "nms": "infer.run", "nms.gate": "nms", "nms.topk": "nms", "nms.keep": "nms",
    "nms.compact": "nms",
}
READERS = {  # the benchmark's new readers -> the span each reads
    "infer_entry_ms.serve": "infer.entry", "backbone_ms.serve": "model.backbone",
    "neck_ms.serve": "model.neck", "head_ms.serve": "model.head",
    "decode_ms.serve": "model.decode", "nms_gate_ms.serve": "nms.gate",
    "nms_topk_ms.serve": "nms.topk", "nms_keep_ms.serve": "nms.keep",
    "nms_compact_ms.serve": "nms.compact",
}
P6_SPANS = {  # the P6 models' spans -> the span each nests in
    "model.backbone.p6": "model.backbone", "model.neck.p6": "model.neck",
    "model.head.p6": "model.head",
}
CELLS = ["yololps-b128-dense", "yolov6m-b128-dense", "yolov6l6-b32-1280-dense"]
INT8_CELL = "yololps-b128-int8-dense"


def recording():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_store():
    P.reset_spans()
    yield
    P.reset_spans()


@pytest.fixture(scope="module")
def inferer():
    return Inferer(None, None, "yololpn", img_size=64, half=False, conf_thres=0.0, max_det=20,
                   device="cpu")


@pytest.fixture(scope="module")
def inferer_p6():
    return Inferer(None, None, "yolov6n6", img_size=128, half=False, conf_thres=0.0, max_det=20,
                   device="cpu")


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3), np.uint8)


class FakeEvent:
    """A CUDA event stand-in on the host clock: `record` notes the time."""
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: None)
    return torch.device("cuda", 0)


class AtenOps(TorchDispatchMode):
    """The aten ops dispatched inside the mode, counted by name."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_nothing_records_with_the_profiler_off(inferer, batch, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: entered.append("event"))
    assert not P.recording()
    assert P.annotate("x", torch.device("cuda", 0)) is P.annotate("y")  # the shared no-op
    P.count("nms.slots", 4)
    inferer._run(batch)
    assert entered == []
    assert P.span_totals() == {} and P.spans() == [] and P.counters() == {}


def test_only_the_counters_ops_are_added_while_recording():
    """The NMS dispatches the same aten ops recording or not, but for the
    gated count's three (a sum an image, the clamp at K, the sum), and
    enters a profiler range only while recording, one a span."""
    pred = decode_with_gate_counts([3, 0])
    with AtenOps() as off:
        non_max_suppression(pred, conf_thres=0.5, pre_nms_topk=4, max_det=4)
    with recording(), AtenOps() as on:
        non_max_suppression(pred, conf_thres=0.5, pre_nms_topk=4, max_det=4)
    def aten(ops):
        return Counter({k: v for k, v in ops.items() if k.startswith("aten.")})

    assert not [k for k in off.ops if k.startswith("profiler.")]
    assert on.ops["profiler._record_function_enter_new.default"] == 5
    assert aten(off.ops) - aten(on.ops) == Counter()
    assert aten(on.ops) - aten(off.ops) == Counter(
        {"aten.sum.dim_IntList": 1, "aten.clamp_.default": 1, "aten.sum.default": 1})


def test_run_records_each_span_once_by_parent_and_request(inferer, batch):
    with recording():
        inferer._run(batch)
        inferer._run(batch)
    spans = P.spans()
    first, second = spans[:len(SERVED)], spans[len(SERVED):]
    for run in (first, second):
        by_name = {s["name"]: s for s in run}
        assert sorted(by_name) == sorted(SERVED) and len(run) == len(SERVED)
        ids = {s["id"]: s["name"] for s in run}
        assert {s["name"]: ids.get(s["parent"]) for s in run} == SERVED
        assert len({s["request"] for s in run}) == 1
        for s in run:
            p = by_name[SERVED[s["name"]]] if SERVED[s["name"]] else None
            assert s["start_ns"] <= s["end_ns"] and s["device_s"] is None
            assert p is None or p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    assert first[0]["request"] != second[0]["request"]
    totals = P.span_totals()
    assert {k: v["count"] for k, v in totals.items()} == {k: 2 for k in SERVED}
    assert all(v["device_count"] == 0 and v["device_s"] is None for v in totals.values())


@pytest.mark.parametrize("name", ["yololpn", "yolov6n6"])
def test_the_p6_spans_nest_in_the_models_and_the_decode_counts_its_anchors(
        name, inferer, inferer_p6):
    inf = inferer_p6 if name == "yolov6n6" else inferer
    size = inf.img_size[0]
    batch = np.random.default_rng(1).integers(0, 255, (2, size, size, 3), np.uint8)
    with recording():
        inf._run(batch)
        inf._run(batch)
    spans = P.spans()
    ids = {s["id"]: s["name"] for s in spans}
    p6 = [s for s in spans if s["name"] in P6_SPANS]
    if name == "yololpn":
        assert p6 == [] and len(spans) == 2 * len(SERVED)
    else:
        assert Counter(s["name"] for s in p6) == {k: 2 for k in P6_SPANS}  # once a forward
        assert all(ids[s["parent"]] == P6_SPANS[s["name"]] for s in p6)
        assert len(spans) == 2 * (len(SERVED) + len(P6_SPANS))
    anchors = sum((size // s) ** 2 for s in inf.model.detect.strides)
    assert anchors == (340 if name == "yolov6n6" else 84)
    assert P.counters()["decode.anchors"] == 2 * 2 * anchors
    rec = {"batch": 2, "trace": {"iters": 2}}
    assert S.reader("decode_anchors.serve")(rec) == anchors


def test_each_chrome_trace_range_holds_its_span(inferer, batch, tmp_path):
    with recording() as prof:
        inferer._run(batch)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = [(e["name"], round(e["ts"] * 1e3) + base, round((e["ts"] + e["dur"]) * 1e3) + base)
              for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    spans = P.spans()
    assert len(spans) == len(SERVED)
    for s in spans:
        assert any(n == s["name"] and a <= s["start_ns"] <= s["end_ns"] <= b
                   for n, a, b in ranges), s


def decode_with_gate_counts(gated, anchors=6):
    """A (len(gated), anchors, 290) decode whose image i has `gated[i]`
    anchors scoring 0.9 (every task's maximum) and the rest 0.1; the boxes
    lie apart."""
    pred = torch.zeros(len(gated), anchors, 290)
    pred[..., 0] = torch.arange(anchors) * 100.0 + 50.0
    pred[..., 1] = 50.0
    pred[..., 2:4] = 20.0
    pred[..., 4] = 1.0
    pred[..., 13:] = 0.1
    for i, n in enumerate(gated):
        pred[i, :n, 13:] = 0.9
    return pred


def test_nms_counters_read_the_gated_slots_exactly():
    pred = decode_with_gate_counts([3, 0])
    with recording():
        _, valid, num = non_max_suppression(pred, conf_thres=0.5, pre_nms_topk=4, max_det=4)
    assert num.tolist() == [3, 0]
    assert P.counters() == {"nms.gated": 3, "nms.slots": 8, "nms.gate_calls": 1,
                            "nms.gate_fused": 1}
    assert S.reader("nms_slot_use.serve")({}) == 37.5
    with recording():
        non_max_suppression(decode_with_gate_counts([6, 5]), conf_thres=0.5, pre_nms_topk=4)
    # min(gated, K) an image
    assert P.counters() == {"nms.gated": 3 + 8, "nms.slots": 16, "nms.gate_calls": 2,
                            "nms.gate_fused": 2}


def test_run_outputs_are_the_same_bits_recording_or_not(inferer, batch):
    off = inferer._run(batch)
    with recording():
        on = inferer._run(batch)
    assert P.span_totals()["infer.run"]["count"] == 1
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_spans_time_the_card_with_pooled_events(fake_card):
    with recording():
        for _ in range(3):  # each request's outermost span returns the events read
            with P.annotate("outer", fake_card):
                with P.annotate("inner", fake_card):
                    time.sleep(0.002)
    totals = P.span_totals()
    assert FakeEvent.made == 4  # two pairs, reused
    assert totals["outer"]["device_count"] == totals["inner"]["device_count"] == 3
    assert totals["outer"]["device_s"] >= totals["inner"]["device_s"] >= 3 * 0.002
    assert all(s["device_s"] is not None for s in P.spans())


def test_the_span_buffer_is_bounded_and_the_totals_are_not(monkeypatch):
    monkeypatch.setattr(P, "MAX_SPANS", 3)
    P.reset_spans()
    with recording():
        for i in range(5):
            with P.annotate(f"s{i}"):
                pass
    assert [s["name"] for s in P.spans()] == ["s2", "s3", "s4"]
    assert sorted(P.span_totals()) == [f"s{i}" for i in range(5)]


def test_threads_record_their_own_requests_and_lose_no_span(monkeypatch):
    """Many threads record at once (a profiler session records only on the
    thread that opened it, so recording is forced on here): each thread's
    spans nest under its own outermost span, and the totals count every
    span and counter."""
    threads, rounds = 16, 50
    monkeypatch.setattr(P, "recording", lambda: True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with P.annotate("outer"):
                    with P.annotate("inner"):
                        P.count("n", 1)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    totals, spans = P.span_totals(), P.spans()
    assert totals["outer"]["count"] == totals["inner"]["count"] == threads * rounds
    assert P.counters() == {"n": threads * rounds}
    outer = {s["id"]: s["request"] for s in spans if s["name"] == "outer"}
    assert len(set(outer.values())) == threads * rounds
    assert all(outer[s["parent"]] == s["request"] for s in spans if s["name"] == "inner")


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers_read_a_filled_store_and_nothing_from_an_empty_one(metric, fake_card):
    read = S.reader(metric)
    assert read({}) is None
    with recording():
        with P.annotate(READERS[metric]):  # host only: no device time to read
            pass
    assert read({}) is None
    with recording():
        for _ in range(2):
            with P.annotate(READERS[metric], fake_card):
                time.sleep(0.001)
    t = P.span_totals()[READERS[metric]]
    assert read({}) == pytest.approx(t["device_s"] / 2 * 1e3) and read({}) >= 1.0


def test_slot_use_reader_reads_nothing_from_an_empty_store():
    assert S.reader("nms_slot_use.serve")({}) is None


def test_p6_reader_sums_the_three_spans_and_reads_nothing_without_them(fake_card):
    read = S.reader("p6_ms.serve")
    assert read({}) is None
    with recording():  # a P5 forward: the model's spans, none of the P6 ones
        for name in ("model.backbone", "model.neck", "model.head"):
            with P.annotate(name, fake_card):
                time.sleep(0.001)
    assert read({}) is None
    with recording():
        for _ in range(2):
            for name in P6_SPANS:
                with P.annotate(name, fake_card):
                    time.sleep(0.001)
    t = P.span_totals()
    assert read({}) == pytest.approx(sum(t[n]["device_s"] / 2 * 1e3 for n in P6_SPANS))
    assert read({}) >= 3.0


def test_anchor_reader_reads_the_counter_an_image_and_nothing_without_it():
    read = S.reader("decode_anchors.serve")
    rec = {"batch": 4, "trace": {"iters": 2}}
    assert read(rec) is None
    with recording():
        P.count("nms.slots", 8)
    assert read(rec) is None
    with recording():
        for _ in range(2):
            P.count("decode.anchors", 4 * 34000)
    assert read(rec) == 34000
    assert read({"batch": 4}) is None  # no profiled slice


def test_quantize_fused_reader_reads_the_share_and_nothing_without_its_data():
    """`quantize_fused.int8`: `int8.quantize_fused` over the `int8.quantize`
    spans, in percent; nothing where no quantize ran or none launched the
    kernel (the counter missing: the plain version, or a program without
    the kernel)."""
    read = S.reader("quantize_fused.int8")
    assert read({}) is None
    with recording():
        with P.annotate("int8.quantize"):
            pass
    assert read({}) is None
    with recording():
        P.count("int8.quantize_fused", 1)
        with P.annotate("int8.quantize"):
            pass
    assert read({}) == 50.0


def test_the_readers_are_the_benchmarks_per_layer_metrics():
    spec = S.load(ROOT)
    names = {m["name"]: m for m in spec["per_layer"]}
    counted = ("nms_slot_use.serve", "decode_anchors.serve")
    for metric in [*READERS, *counted, "p6_ms.serve"]:
        m = names[metric]
        assert m["moves"] == "images_per_s"
        assert m["source"] == ("program_counter" if metric in counted else "program_span")
        assert m["workloads"] == (CELLS[2:] if metric == "p6_ms.serve" else CELLS + [INT8_CELL])
    for metric in ("mfu.int8", "int8_conv_roofline.int8", "quantize_ms.int8"):
        assert names[metric]["workloads"] == [INT8_CELL]


class NMSModule(torch.nn.Module):
    def forward(self, pred):
        with P.annotate("export.block", pred.device):
            pred = pred * 1.0
        return non_max_suppression(pred, conf_thres=0.5, pre_nms_topk=4, max_det=4)


def test_an_exported_graph_holds_no_profiler_op():
    with recording():
        program = torch.export.export(NMSModule(), (decode_with_gate_counts([3, 0]),))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "yololp_torch.greedy_nms_mask.default" in targets
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    assert P.spans() == [] and P.counters() == {}  # export traced the program, recorded nothing


def test_fps_is_images_over_seconds():
    fps = CalcFPS(nsamples=2)
    assert fps.accumulate() == 0.0
    fps.update(0.5, 4)
    fps.update(0.1, 4)
    assert fps.accumulate() == pytest.approx(8 / 0.6)  # not the mean of 8 and 40
    fps.update(0.2, 2)  # the oldest batch leaves
    assert fps.accumulate() == pytest.approx(6 / 0.3)


@pytest.mark.parametrize("deploy", [False, True], ids=["train_graph", "deploy"])
def test_the_residual_counters_count_each_shortcut_bottlerep(deploy):
    """A CSP model (yolov6m: BepC3 blocks of BottleReps) counts
    `block.residual` once for each shortcut BottleRep a forward runs, and
    `block.residual_fused` as often on the deploy graph's fused path; the
    train graph fuses none."""
    from yololp_tpu_torch.layers.blocks import BottleRep
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.utils.config import Config

    torch.manual_seed(0)
    model = Model(Config.named("yolov6m"), deploy=deploy).eval()
    shortcuts = sum(isinstance(m, BottleRep) and m.shortcut for m in model.modules())
    assert shortcuts == 24
    x = torch.randn(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), recording():
        model(x)
    c = P.counters()
    assert c["block.residual"] == shortcuts
    assert c.get("block.residual_fused", 0) == (shortcuts if deploy else 0)
    assert S.reader("residual_fused.serve")({}) == (100.0 if deploy else 0.0)


def test_the_int8_run_records_its_spans_and_counts_its_launches(batch):
    """An Inferer serving its int8 plan runs inside the served path's spans,
    opens `int8.quantize` inside the model's spans once a float -> code
    quantize, and counts the plan's 68 int8 conv launches and the elements
    it quantized; `int8.quantize_fused` counts the quantize kernel's
    launches, so the CPU's plain version leaves it and `quantize_fused.int8`
    empty (the card test reads it there); the float path opens no `int8.*`
    span and counts nothing of them."""
    from yololp_tpu_torch.quant import int8_infer
    from yololp_tpu_torch.quant.quantize import calibrate

    inf = Inferer(None, None, "yololpn", img_size=64, half=True, conf_thres=0.0, max_det=20,
                  device="cpu")
    with recording():
        inf._run(batch)
    assert set(P.span_totals()) == set(SERVED)
    assert not {"int8.convs", "int8.quantized", "int8.quantize_fused"} & set(P.counters())
    amax = calibrate(inf.model, [batch], device="cpu")
    inf.use_int8(amax)
    floats = []  # the float inputs of the int8 modules: each quantized once

    def seen(_m, args):
        if args[0].is_floating_point():
            floats.append(args[0].numel())

    hooks = [m.register_forward_pre_hook(seen) for m in inf.model.modules()
             if isinstance(m, (int8_infer.Int8Conv2d, int8_infer.Int8RepBlock))]
    P.reset_spans()
    with recording():
        det, valid, num = inf._run(batch)
    for h in hooks:
        h.remove()
    totals, spans = P.span_totals(), P.spans()
    assert set(totals) == set(SERVED) | {"int8.quantize"}
    assert all(totals[n]["count"] == 1 for n in SERVED)
    by_id = {s["id"]: s["name"] for s in spans}
    parents = {by_id[s["parent"]] for s in spans if s["name"] == "int8.quantize"}
    assert parents == {"model.backbone", "model.neck", "model.head"}
    c = P.counters()
    assert c["int8.convs"] == 68 and int(num.min()) > 0
    assert totals["int8.quantize"]["count"] == len(floats) > 0
    assert c["int8.quantized"] == sum(floats)
    assert "int8.quantize_fused" not in c
    assert S.reader("quantize_fused.int8")({}) is None
    P.reset_spans()
    again = inf._run(batch)  # recording nothing, the same bits
    assert P.counters() == {} and all(torch.equal(a, b) for a, b in zip((det, valid, num), again))
