"""The Inferer's true-int8 plan (`Inferer.use_int8`, the `conv` plan) against
the benchmark's plain int8 reference (benchmark/reference/int8.py), on the
CPU at yololpn widths and 128 px, on seeded weights, with the port's CPU
versions of the int8 conv (`cuda_conv.int8_conv_plain`).

Both run in fp32 on the same seeded weights (the reference folds them
itself, in fp32 as the deployment folds) and the same amax table, so their
float layers agree to rounding and every int8 conv's input codes must
agree exactly; so must the plan (which convs hand codes off, how many
elements are quantized from float). The decodes then differ only by the
decode's own fp32 arithmetic (`DECODE_TOL`), and on these seeds not at all. The port's max calibration
matches the reference's to fp32 rounding (`AMAX_RTOL`). A per-tensor weight
scale or a dropped handoff fails the comparison. And the Inferer's int8
`_run` equals `make_int8_infer_fn`'s run, and the composition it replaced,
bit for bit."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yololp_tpu_torch.core.inferer import Inferer
from yololp_tpu_torch.layers.fuse import fuse_state_dict
from yololp_tpu_torch.ops import cuda_conv
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.quant import int8_infer
from yololp_tpu_torch.quant.quantize import _image_tensor, calibrate, module_path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.reference import int8 as ref_int8  # noqa: E402
from benchmark.weights import port_config, seeded_state_dict  # noqa: E402

torch.set_num_threads(2)

SIZE = 128
# Equal codes give equal maps, and the two decodes came out equal bit for bit
# on three seeds; the limit leaves room for another order of the decode's fp32
# sums (a few ulps of 128-px boxes, 1e-5 px). The reference with its float
# layers in bf16 misses it by 6-9 px and 0.05-0.10 in a score.
DECODE_TOL = dict(rtol=0.0, atol=1e-4)
# The program calibrates on its fp32 deploy model, the reference on its own
# fp32 forward of the same fused weights (their entries divide by 255 in
# other ways): measured 1.35e-6 at most over three seeds; 7x room.
AMAX_RTOL = 1e-5


def config():
    """yololps' int8 configuration at yololpn's multipliers and 128 px."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "yololps_int8.json").read_text())
    cfg["model"].update(depth_multiple=0.33, width_multiple=0.25)
    return {**cfg, "img_size": SIZE}


@pytest.fixture(scope="module")
def case():
    cfg = config()
    sd = seeded_state_dict(cfg, 2**33 + 23, torch.device("cpu"))
    fused = fuse_state_dict(sd)
    g = torch.Generator().manual_seed(4)
    calib = [torch.randint(0, 256, (2, SIZE, SIZE, 3), dtype=torch.uint8, generator=g)
             for _ in range(2)]
    images = torch.randint(0, 256, (2, SIZE, SIZE, 3), dtype=torch.uint8, generator=g)
    v = cfg["vocab"]
    inf = Inferer(None, fused, port_config(cfg), img_size=SIZE, half=False, conf_thres=0.0,
                  max_det=50, npro=v["npro"], nalp=v["nalp"], nads=v["nads"], device="cpu")
    amax = calibrate(inf.model, calib, device="cpu")
    return dict(cfg=cfg, sd=sd, fused=fused, calib=calib, images=images, inf=inf, amax=amax)


def int8_inferer(case):
    cfg, v = case["cfg"], case["cfg"]["vocab"]
    inf = Inferer(None, case["fused"], port_config(cfg), img_size=SIZE, half=False,
                  conf_thres=0.0, max_det=50, npro=v["npro"], nalp=v["nalp"], nads=v["nads"],
                  device="cpu")
    return inf.use_int8(case["amax"])


def program_codes(inf, images, monkeypatch):
    """{path: [input codes, NCHW]} of every int8 conv launch of one `_run`,
    the paths whose launch writes int8 codes (a handoff), and the elements
    quantized from float."""
    by_ptr = {}
    for name, m in inf.model.named_modules():
        if isinstance(m, int8_infer.Int8Conv2d):
            by_ptr[m.w_q.data_ptr()] = module_path(name)
        elif isinstance(m, int8_infer.Int8RepBlock):
            for p, link in zip(m.sub_paths, m.plan[1]):
                by_ptr[link[0].data_ptr()] = p
    codes, handed, quantized = {}, set(), []
    real_conv, real_q = cuda_conv.int8_conv, cuda_conv.quantize_codes

    def conv(x_q, w_q, a, b, stride=1, relu=True, out_dtype=torch.int8):
        path = by_ptr[w_q.data_ptr()]
        codes.setdefault(path, []).append(x_q.permute(0, 3, 1, 2).contiguous())
        if out_dtype == torch.int8:
            handed.add(path)
        return real_conv(x_q, w_q, a, b, stride, relu, out_dtype)

    def quantize(x, inv_scale):
        quantized.append(x.numel())
        return real_q(x, inv_scale)

    monkeypatch.setattr(cuda_conv, "int8_conv", conv)
    monkeypatch.setattr(cuda_conv, "quantize_codes", quantize)
    out = inf._run(images)
    monkeypatch.undo()
    return codes, handed, sum(quantized), out


def reference_codes(case, images):
    codes = {}
    dec = ref_int8.decode_images(case["sd"], case["cfg"], images, case["amax"],
                                 rounding=None, codes=codes)
    handoffs = ref_int8.plan(case["cfg"], case["amax"])
    from benchmark.flops.int8 import int8_work

    work = int8_work(case["cfg"], case["amax"], SIZE, SIZE, images.shape[0], out_bytes=4)
    return codes, {ref_int8.path_of(p) for p in handoffs}, work["quantized"] * images.shape[0], dec


def differences(prog, want) -> list:
    """What differs between the program's (codes, handed, quantized) and the
    reference's: paths, or the name of the count."""
    (pc, ph, pq), (rc, rh, rq) = prog, want
    bad = sorted(p for p in set(pc) | set(rc)
                 if p not in pc or p not in rc or len(pc[p]) != len(rc[p])
                 or not all(torch.equal(a, b) for a, b in zip(pc[p], rc[p])))
    bad += sorted(ph ^ rh)
    return bad + (["quantized"] if pq != rq else [])


def test_the_int8_run_matches_the_plain_int8_reference(case, monkeypatch):
    inf = int8_inferer(case)
    pc, ph, pq, _ = program_codes(inf, case["images"], monkeypatch)
    rc, rh, rq, dec = reference_codes(case, case["images"])
    # 68 int8 convs, 30 of them the links of 8 chains; 22 links hand off inside
    # their chains, 2 chain exits and 13 seams to their consumers
    assert len(pc) == sum(len(v) for v in pc.values()) == 68 and len(ph) == 37
    assert differences((pc, ph, pq), (rc, rh, rq)) == []
    pred = inf.predict(case["images"])
    assert pred.shape == dec.shape == (2, 336, 290)
    torch.testing.assert_close(pred, dec, **DECODE_TOL)


def test_the_calibration_matches_the_references(case):
    want = ref_int8.calibrate(case["sd"], case["cfg"], case["calib"], rounding=None)
    got = case["amax"]
    assert set(got) == set(want) and len(got) == 70  # 68 int8 convs, 2 transposed convs
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=AMAX_RTOL), k


def _per_tensor(state, skip=int8_infer.DEFAULT_SKIP_SUBSTRINGS, device=None):
    """quantize_kernels_int8 with one weight scale a kernel (the largest
    channel's)."""
    out = {}
    for p, (w_q, scale, bias) in REAL_KERNELS(state, skip, device).items():
        w = w_q.float() * scale.reshape(-1, 1, 1, 1)
        if w_q.shape[0] != scale.shape[0]:  # a transposed conv's kernel: left as it is
            out[p] = (w_q, scale, bias)
            continue
        one = scale.max().expand_as(scale).clone()
        out[p] = (torch.round(w / one.reshape(-1, 1, 1, 1)).clamp(-128, 127).to(torch.int8),
                  one, bias)
    return out


REAL_KERNELS = int8_infer.quantize_kernels_int8


def _dropped_handoff(*a, **k):
    h = REAL_HANDOFFS(*a, **k)
    h.pop("backbone/ERBlock_3_down/conv")
    return h


REAL_HANDOFFS = int8_infer.graph_handoffs


@pytest.mark.parametrize("fault", ["per_tensor_weight_scale", "dropped_handoff"])
def test_a_broken_plan_fails_the_comparison(case, fault, monkeypatch):
    if fault == "per_tensor_weight_scale":
        monkeypatch.setattr(int8_infer, "quantize_kernels_int8", _per_tensor)
    else:
        monkeypatch.setattr(int8_infer, "graph_handoffs", _dropped_handoff)
    inf = int8_inferer(case)
    monkeypatch.undo()
    prog = program_codes(inf, case["images"], monkeypatch)[:3]
    bad = differences(prog, reference_codes(case, case["images"])[:3])
    if fault == "dropped_handoff":
        assert "backbone/ERBlock_3_down/conv" in bad and "quantized" in bad
    else:
        assert len(bad) > 40


def test_the_int8_run_equals_the_bare_function_bit_for_bit(case):
    inf = int8_inferer(case)
    base = case["inf"]
    kw = dict(conf_thres=inf.conf_thres, iou_thres=inf.iou_thres, max_det=inf.max_det,
              device="cpu")
    run = int8_infer.make_int8_infer_fn(base.model, base.variables, case["amax"], **kw)
    images = case["images"].numpy()
    got, wrapped = inf._run(images), run(images)
    # the composition the wrapper replaced: the swapped model on the
    # calibration's image tensor, the NMS on its fp32 widening
    model = int8_infer.build_int8_model(
        base.model, case["amax"], int8_infer.quantize_kernels_int8(base.variables, device="cpu"))
    with torch.inference_mode():
        pred = model(_image_tensor(images, torch.device("cpu"), torch.float32))
        old = non_max_suppression(pred.float(), **{k: v for k, v in kw.items() if k != "device"})
    assert int(got[2].min()) > 0
    for a, b, c in zip(got, wrapped, old):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert np.array_equal(inf.predict(images).numpy(), pred.numpy())
