"""The int8 cell (kinds/serve_int8.py, reference/int8.py, flops/int8.py and
its three readers) on the CPU at a size a test run can hold (yololps' widths
and depth, 128-pixel frames, 2-image batches, the port's CPU version of the
int8 conv):

- the sound program reads `correct` true, and a run's last line has the
  contract's keys;
- faults read false: a per-tensor weight scale (by `conf_err_ratio`), a
  handoff dropped to dequantize-then-quantize (by `plan_counts_differ`: in
  numbers it is nearly the same plan), a batch answered rolled by one image
  (by `nms_images_differ`);
- the control (6-bit codes, fp8 calibration) reads false under the limits;
- the int8 reference runs on its own calibration, its decodes once, in
  set-up, whose seconds `setup_s` leaves out;
- the plan's count: 68 int8 conv launches, whose operations and the float
  convs' FLOPs add up to the fused forward's FLOPs;
- the new readers read nothing without what they read.
Run: python -m pytest benchmark/tests -q"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, run, spec as S  # noqa: E402
from benchmark.flops.int8 import int8_work  # noqa: E402
from benchmark.flops.model import forward_flops  # noqa: E402

SPEC = S.load(ROOT)
CELL = "yololps-b128-int8-dense"
SMALL = {"config": {"img_size": 128},
         "traffic": {"batch": 2, "frame": [128, 128], "pool": 2, "trace_iters": 2,
                     "warmup_rounds": 1, "calib_batch": 2}}
SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def no_cuda_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def run_small(trace=False):
    return run.run_cell(SPEC, CELL, SEED, 0.2, trace, torch.device("cpu"), time.perf_counter(),
                        SMALL)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_sound_program_reads_correct_with_the_contract_keys(trace):
    r = run_small(bool(trace))
    assert r["correct"] is True, r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    json.dumps(r)
    names = [m["name"] for m in (S.per_layer(SPEC, CELL) if trace else S.end_to_end(SPEC, CELL))]
    assert set(r["metrics"]) <= set(names)
    if trace:  # no card: the device's spans and kernels are not there to read
        assert {"mfu.int8", "nms_slot_use.serve"} <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"images_per_s", "setup_s"}
    assert set(r["checks"]) == set(S.limits(CELL))


def _per_tensor(real):
    def kernels(state, skip=None, device=None):
        out = {}
        for p, (w_q, scale, bias) in real(state, skip, device).items():
            one = scale.max().expand_as(scale).clone()
            w = w_q.float() * scale.reshape(-1, 1, 1, 1)
            out[p] = (torch.round(w / one.reshape(-1, 1, 1, 1)).clamp(-128, 127).to(torch.int8),
                      one, bias)
        return out
    return kernels


def _break(monkeypatch, how):
    from yololp_tpu_torch.core import inferer
    from yololp_tpu_torch.quant import int8_infer

    if how == "per_tensor_weight_scale":
        monkeypatch.setattr(int8_infer, "quantize_kernels_int8",
                            _per_tensor(int8_infer.quantize_kernels_int8))
    elif how == "dropped_handoff":
        real = int8_infer.graph_handoffs

        def dropped(*a, **k):
            h = real(*a, **k)
            h.pop("backbone/ERBlock_3_down/conv")
            return h

        monkeypatch.setattr(int8_infer, "graph_handoffs", dropped)
    else:
        sound = inferer.Inferer._run
        monkeypatch.setattr(inferer.Inferer, "_run",
                            lambda self, images: tuple(o.roll(1, 0) for o in sound(self, images)))


FAULTS = {"per_tensor_weight_scale": "conf_err_ratio", "dropped_handoff": "plan_counts_differ",
          "rolled_batch": "nms_images_differ"}


@pytest.mark.parametrize("how", sorted(FAULTS))
def test_a_fault_reads_incorrect(how, monkeypatch):
    _break(monkeypatch, how)
    r = run_small()
    assert r["correct"] is False, r["checks"]
    c = r["checks"][FAULTS[how]]
    assert c["value"] > c["limit"], r["checks"]


def small_driver():
    c = S.cell(SPEC, CELL)
    cfg = {**S.config(SPEC, c["config"]), **SMALL["config"]}
    tr = {**S.traffic(c["traffic"]), **SMALL["traffic"]}
    d = S.kind(tr["kind"]).Driver(cfg, tr, SEED, torch.device("cpu"), lambda m: None)
    d.setup(False)
    return d


def test_the_control_fails_the_limits():
    d = small_driver()
    numbers = d.control()
    limits = {k: v for k, v in S.limits(CELL).items() if k in numbers}
    assert set(limits) == {"int8_departure", "conf_err_ratio", "amax_rel_err"}
    ok, checks = check.judge(numbers, limits)
    assert not ok, checks


def test_the_reference_runs_on_its_own_calibration_once_and_outside_setup_s(monkeypatch):
    """Every int8 reference decode runs on the reference's own calibration
    (never the program's table); the fp32 and int8 reference decodes run
    once, in set-up for the gate, and not again in the check, which takes
    their seconds off `setup_s`."""
    from benchmark.kinds import serve_int8

    tables, fp32 = [], []
    int8_real, fp32_real = serve_int8.ref_int8.decode_images, serve_int8.ref_model.decode_images

    def int8_spy(sd, cfg, images, amax, *a, **k):
        tables.append(amax)
        return int8_real(sd, cfg, images, amax, *a, **k)

    def fp32_spy(*a, **k):
        fp32.append(1)
        return fp32_real(*a, **k)

    monkeypatch.setattr(serve_int8.ref_int8, "decode_images", int8_spy)
    monkeypatch.setattr(serve_int8.ref_model, "decode_images", fp32_spy)
    d = small_driver()
    n = len(d.pool)
    assert len(tables) == len(fp32) == n and all(t is d.ref_amax for t in tables)
    assert d.ref_amax == serve_int8.ref_int8.calibrate(d.sd, d.cfg, d.calib, "bf16", d.skip)
    rec = d.window(0.2)
    rec["setup_s"] = 100.0
    numbers = d.check(rec)
    assert len(tables) == len(fp32) == n
    assert 0 < d.ref_s and rec["setup_s"] == 100.0 - d.ref_s
    assert numbers["amax_rel_err"] == serve_int8.rel_err(d.amax, d.ref_amax)


def test_the_plan_counts_every_int8_conv_once():
    cfg = S.config(SPEC, "yololps-int8")

    class Amax(dict):  # every conv calibrated
        def __contains__(self, k):
            return True

    work = int8_work(cfg, Amax(), 640, 640, 128)
    assert work["convs"] == len(work["launches"]) == 68
    assert work["int8_ops"] + work["float_flops"] == forward_flops(cfg, 640, 640)
    assert all(ops > 0 and nbytes > 0 for ops, nbytes in work["launches"])


def test_the_new_readers_read_nothing_without_their_data():
    from yololp_tpu_torch.utils import profiler

    profiler.reset_spans()
    for name in ("mfu.int8", "int8_conv_roofline.int8", "quantize_ms.int8"):
        assert S.reader(name)({}) is None
    rec = {"trace": {"kernels": {"int8_conv_kernel<128, 0, true>": [1e-3, 1e-3]}, "iters": 1},
           "int8_work": {"launches": [(1e9, 1e6)], "convs": 2}}
    assert S.reader("int8_conv_roofline.int8")(rec) is None  # the program counted no launch
