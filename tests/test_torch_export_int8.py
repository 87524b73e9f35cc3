"""Port parity: the int8 export (yololp_tpu_torch/export/export.py with an amax
file) against the live int8 port and the JAX int8 StableHLO artifact, on
the CPU.

tests/test_torch_export.py's checkpoint, images and thresholds; the amax
file is the port's (calibrate, save_amax), read by both exports. The end2end
program holds one `yololp_torch.int8_conv` node per launch that the live
plan (`make_int8_infer_fn(device="cpu")`, int8_apply's default "conv" plan)
makes, chain links included, and its int8 kernels among its constants (the
analogue of tests/test_export.py's `b"i8" in blob`); saved and loaded, its
det/valid/num equal the live plan's bit for bit.

Its raw decode against the JAX int8 artifact's: XLA's CPU contracts the JAX
epilogue `acc * a + b` into an FMA, the port (its kernel and its plain
version alike) rounds the multiply and the add separately, and where that
moves a requantized code across a rounding tie the flip spreads through the
random-weight graph: on the first image here one flip grows to 16.5 px, far
past tests/test_torch_int8.py's FLIP allowance (2 px). So the decode is held
with the port's epilogue rounded as XLA rounds it (`fma_epilogue`), which
isolates that one known difference, to the STRICT bounds (1e-3 score,
0.05 px); the export itself is held to the live port bit for bit.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_export import IMG, KW, jax_artifact, run_pt2, setup  # noqa: F401 (a fixture)
from test_torch_int8 import STRICT_PX, STRICT_SCORE
from yololp_tpu_torch.export.export import export_pt2
from yololp_tpu_torch.ops import cuda_conv
from yololp_tpu_torch.quant.int8_infer import make_int8_infer_fn
from yololp_tpu_torch.quant.quantize import calibrate, save_amax

torch.set_num_threads(2)


class CountOps(TorchDispatchMode):
    """Counts the yololp_torch.int8_conv calls under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.yololp_torch.int8_conv.default
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def int8_setup(setup):  # noqa: F811
    d, ckpt, inf, batch = setup
    amax = calibrate(inf.model, [batch], device="cpu")
    calib_pt = str(d / "amax.json")
    save_amax(amax, calib_pt)
    return d, ckpt, inf, batch, amax, calib_pt


def test_int8_pt2_equals_the_live_plan(int8_setup):
    d, ckpt, inf, batch, amax, calib_pt = int8_setup
    paths = export_pt2("yololpn", ckpt, str(d / "m_int8"), batch=2, img_size=IMG, half=False,
                       calib_pt=calib_pt, device="cpu", **KW)
    assert json.load(open(paths["json"]))["int8"] is True
    program = torch.export.load(paths["pt2"])
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    run = make_int8_infer_fn(inf.model, inf.variables, amax, device="cpu", **KW)
    with CountOps() as count:
        want = run(batch)
    assert count.n > 30  # 8 chains' links and the per-conv launches
    assert nodes.count("yololp_torch.int8_conv.default") == count.n
    assert nodes.count("yololp_torch.greedy_nms_mask.default") == 1
    # the int8 kernels travel inside the program: registered buffers and the
    # chains' links (lifted constants)
    int8 = [t for t in list(program.state_dict.values()) + list(program.constants.values())
            if t.dtype == torch.int8]
    assert len(int8) == count.n
    got = run_pt2(paths["pt2"], batch)
    for name, a, b in zip(("det", "valid", "num"), got, want):
        assert torch.equal(a, b), name
    assert int(got[2].min()) > 0


def fma_epilogue(acc, a, b, relu, out_dtype):
    """cuda_conv.epilogue_plain with `acc * a + b` rounded once, as XLA's
    FMA rounds it: the product is exact in float64 (|acc| < 2**27, a has 24
    bits), the sum rounded to float64 and then to float32 (which differs
    from one rounding only where the float64 sum is a float32 tie)."""
    if out_dtype == torch.int32:
        return acc
    y = (acc.double() * a.double() + b.double()).float()
    if out_dtype == torch.int8:
        return torch.round(y).clamp(0.0 if relu else -128.0, 127.0).to(torch.int8)
    return (torch.relu(y) if relu else y).to(out_dtype)


def test_int8_raw_decode_matches_the_jax_int8_artifact(int8_setup, monkeypatch):
    d, ckpt, inf, batch, amax, calib_pt = int8_setup
    paths = export_pt2("yololpn", ckpt, str(d / "raw_int8"), batch=2, img_size=IMG, half=False,
                       end2end=False, calib_pt=calib_pt, device="cpu", **KW)
    got = run_pt2(paths["pt2"], batch).numpy()
    live = make_int8_infer_fn(inf.model, inf.variables, amax, with_nms=False, device="cpu", **KW)
    assert np.array_equal(got, live(batch).numpy())
    (want,) = jax_artifact(d, ckpt, batch, False, "raw_int8.stablehlo", calib_pt=calib_pt)
    # the op's CPU kernel (the plain version) reads the epilogue at call time
    monkeypatch.setattr(cuda_conv, "epilogue_plain", fma_epilogue)
    got = run_pt2(paths["pt2"], batch).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d_score = np.abs(got[..., 13:] - want[..., 13:])
    d_px = np.abs(got[..., :13] - want[..., :13])
    n_off = int((d_score > STRICT_SCORE).sum() + (d_px > STRICT_PX).sum())
    assert n_off == 0, (f"{n_off} decode values beyond {STRICT_SCORE} / {STRICT_PX} px; max "
                        f"{d_score.max()} score, {d_px.max()} px")
