"""The float -> int8 code quantize as the op `yololp_torch::quantize_codes`
(yololp_tpu_torch/ops/cuda_quantize.py, csrc/quantize.cu), on the CPU.

The op's plain version (its CPU kernel) equals the expression the int8 plan
ran before the op, and numpy's fp32 product rounded half to even, bit for
bit, on the hard values (every half-way point, +-inf, beyond the clip, -0.0,
subnormals) in bf16 and fp32, channels_last and contiguous, and keeps x's
strides; the fake gives those strides too. The launcher refuses what the
kernel does not take before it looks for a card. The int8 plan's quantizes
reach the op; the end2end int8 program holds it, and the program that
export.inductor_program writes for Inductor holds none. The card cases'
shapes are the plan's. The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kernel_cases import OPS, QUANTIZE_SHAPES, quantize_edges
from yololp_tpu_torch.ops import cuda_conv, cuda_quantize

ROOT = Path(__file__).resolve().parents[1]
QUANTIZE = torch.ops.yololp_torch.quantize_codes


def todays_codes(x, inv_scale):
    """The int8 plan's quantize before the op (cuda_conv.quantize_codes)."""
    return torch.round(x.float() * inv_scale).clamp(-128.0, 127.0).to(torch.int8)


def numpy_codes(x, inv_scale):
    """fp32 product, rounded half to even, clipped: numpy's arithmetic."""
    with np.errstate(over="ignore"):  # 1e30 and the dtype's max overflow to inf, as in fp32
        v = np.float32(x.float().numpy()) * np.float32(inv_scale)
    return torch.from_numpy(np.clip(np.rint(v), -128, 127).astype(np.int8))


def layouts(t):
    """The flat t, and its first values as channels_last and contiguous
    1 x 16 x 1 x W tensors."""
    n = t.numel() - t.numel() % 16
    v = t[:n].reshape(1, 16, 1, n // 16)
    return {"channels_last": v.contiguous(memory_format=torch.channels_last),
            "contiguous": v.contiguous(), "flat": t}


@pytest.mark.parametrize("inv_scale", [1.0, cuda_conv.inv_host_scale(6.0), 0.5])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous", "flat"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_the_plain_version_is_todays_expression_bit_for_bit(dtype, layout, inv_scale):
    x = layouts(torch.cat([quantize_edges(dtype), (3 * torch.randn(4096)).to(dtype)]))[layout]
    got = QUANTIZE(x, inv_scale)
    assert got.dtype == torch.int8 and got.stride() == x.stride()
    assert torch.equal(got, todays_codes(x, inv_scale))
    assert torch.equal(got.flatten(), numpy_codes(x.flatten(), inv_scale))
    assert torch.equal(cuda_quantize.quantize_codes_plain(x, inv_scale), got)


def test_the_bf16_widening_through_the_bits_is_the_cast_bit_for_bit():
    """`widened` (the plain version's bf16 -> fp32, written through the bits
    so that Inductor keeps the input's bf16 rounding) equals `.float()` on
    every one of the 65536 bf16 bit patterns, NaNs included, with x's
    strides."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    got = cuda_quantize.widened(x)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), x.float().view(torch.int32))
    y = x[:4096].reshape(2, 16, 8, 16).contiguous(memory_format=torch.channels_last)
    assert cuda_quantize.widened(y).stride() == y.stride()
    f = torch.randn(8)
    assert cuda_quantize.widened(f) is f


def test_the_edges_give_the_codes_they_should():
    codes = QUANTIZE(quantize_edges(torch.float32), 1.0)
    k = np.arange(-128, 128)
    half_even = np.where(k % 2 == 0, k, k + 1).clip(-128, 127)  # k + 0.5 rounds to even
    assert codes[:256].tolist() == half_even.tolist()
    assert codes[256:512].tolist() == k.tolist()
    assert codes[512:768].tolist() == k.tolist()  # k + 0.25 rounds down
    special = codes[768:782].tolist()
    assert special == [127, -128, 0, 0, 127, 127, 127, -128, -128, -128, 127, -128, 127, -128]
    assert codes[782:].tolist() == [0, 0, 0, 127, -128]


@pytest.mark.parametrize("fmt", [torch.channels_last, torch.contiguous_format])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_opcheck_quantize_codes(dtype, fmt):
    x = (2 * torch.randn(2, 24, 5, 7)).to(dtype).contiguous(memory_format=fmt)
    result = torch.library.opcheck(QUANTIZE.default, (x, cuda_conv.inv_host_scale(4.0)))
    assert set(result.values()) == {"SUCCESS"}, result
    fake = QUANTIZE(x.to("meta"), 2.0)
    assert fake.dtype == torch.int8 and fake.stride() == x.stride()


@pytest.mark.parametrize("i", range(len(OPS["quantize_codes"].refusals)))
def test_the_launcher_refuses_what_the_kernel_does_not_take(i):
    """Each card refusal raises before the launcher looks for a card."""
    make, err, match = OPS["quantize_codes"].refusals[i]
    with pytest.raises(err, match=match):
        cuda_quantize.quantize_codes_cuda(*make("cpu"))


def test_the_op_takes_every_floating_tensor_on_the_cpu():
    """The record's check refuses no floating tensor: the plain version is
    the CPU's kernel, whatever the layout or dtype."""
    for x in (torch.randn(4, 8, 6)[:, ::2], torch.randn(3, 5).half(), torch.randn(3, 5).double()):
        assert torch.equal(QUANTIZE(x, 3.0), todays_codes(x, 3.0))
    with pytest.raises(TypeError, match="floating"):
        QUANTIZE(torch.zeros(3, dtype=torch.int8), 1.0)


def test_density_is_any_permutation_of_a_contiguous_tensor():
    x = torch.zeros(2, 8, 4, 4)
    assert cuda_quantize.is_dense(x)
    assert cuda_quantize.is_dense(x.contiguous(memory_format=torch.channels_last))
    assert cuda_quantize.is_dense(x.permute(0, 2, 3, 1))
    assert cuda_quantize.is_dense(torch.zeros(1, 8, 1, 1)[:, :, :, :])
    assert cuda_quantize.is_dense(torch.zeros(0, 3)[:, :2])
    assert not cuda_quantize.is_dense(x[..., ::2])
    assert not cuda_quantize.is_dense(x[:, :4])
    assert not cuda_quantize.is_dense(torch.zeros(4, 1).expand(4, 3))


def test_the_plans_quantize_calls_the_op():
    """cuda_conv.quantize_codes, which the int8 plan calls, reaches the op: a
    meta tensor has no kernel of its own, and the op's fake answers."""
    x = torch.randn(2, 8, 4, 4).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    assert torch.equal(cuda_conv.quantize_codes(x, 5.0), todays_codes(x, 5.0))
    meta = cuda_conv.quantize_codes(x.to("meta"), 5.0)
    assert meta.device.type == "meta" and meta.dtype == torch.int8 and meta.stride() == x.stride()


@pytest.fixture(scope="module")
def int8_program():
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.export.export import build_export_fn, export_program
    from yololp_tpu_torch.quant.quantize import calibrate

    torch.manual_seed(0)
    inf = Inferer(None, None, "yololpn", img_size=64, half=False, conf_thres=0.0, max_det=20,
                  device="cpu")
    images = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3), np.uint8)
    amax = calibrate(inf.model, [images], device="cpu")
    module = build_export_fn(inf.model, inf.variables, end2end=True, conf_thres=0.0,
                             max_det=20, calib_amax=amax)
    return module, export_program(module, 2, 64, "cpu"), torch.from_numpy(images)


def test_the_inductor_program_of_the_int8_export_holds_no_quantize_node(int8_program):
    from yololp_tpu_torch.export.export import inductor_program

    module, program, images = int8_program
    op = "yololp_torch.quantize_codes.default"

    def targets(p):
        return [str(n.target) for n in p.graph.nodes if n.op == "call_function"]

    assert targets(program).count(op) > 10
    decomposed = inductor_program(program)
    assert op not in targets(decomposed)
    assert targets(decomposed).count("yololp_torch.int8_conv.default") == \
        targets(program).count("yololp_torch.int8_conv.default")
    with torch.no_grad():
        want = module(images)
        for got in (program.module()(images), decomposed.module()(images)):
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_card_cases_are_the_plans_largest_and_smallest_quantizes():
    """QUANTIZE_SHAPES (tests/kernel_cases.py) against the shapes the yololps
    int8 plan quantizes at 640, b128 (benchmark/flops/int8.py's count)."""
    sys.path.insert(0, str(ROOT))
    from benchmark import spec as S
    from benchmark.flops import int8 as fi

    class Amax(dict):  # every conv calibrated
        def __contains__(self, k):
            return True

    shapes = []

    class Count(fi.Count):
        def conv(self, prefix, x, cout, k, s=1):
            if fi.ref_int8.int8_unit(prefix, self.amax, self.skip) and prefix not in self.fed:
                shapes.append((128, *x.shape[1:]))
            return super().conv(prefix, x, cout, k, s)

    cfg = S.config(S.load(ROOT), "yololps-int8")
    real = fi.Count
    fi.Count = Count
    try:
        work = fi.int8_work(cfg, Amax(), 640, 640, 128)
    finally:
        fi.Count = real
    assert len(shapes) == 32 and sum(np.prod(s) for s in shapes) == work["quantized"] * 128
    assert max(shapes, key=np.prod) == QUANTIZE_SHAPES["largest"]
    assert min(shapes, key=np.prod) == QUANTIZE_SHAPES["head_20x20"]
