"""The kernels as `yololp_torch` custom ops (yololp_tpu_torch/ops/library.py).

`torch.library.opcheck` holds each op's schema, its fake implementation
(shapes, dtypes and strides without data, dynamic shapes included) and its
CPU kernel (the plain version) to one another on small inputs: greedy NMS
at a ragged K with a score-0 tail, an int8 conv with stride 2 and a
reduction K = 9 C that is not a multiple of 16, int8 and bf16 matmuls at
ragged sizes, and `matmul_nt` on a conv tap's strided weights. The wrappers
the call sites use reach the ops (a fake tensor runs the fake kernel), and
the C++ registration of the native runner (deploy/aoti_cpp/ops.cpp) holds
the same schema text.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yololp_tpu_torch.ops import cuda_conv, cuda_matmul, cuda_nms, library

ROOT = Path(__file__).resolve().parents[1]
OPS = torch.ops.yololp_torch


def nms_inputs(b=2, k=37, zero_tail=7, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(2, 30, (b, k, 2)).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.1, 1, (b, k)).astype(np.float32), axis=1)
    scores[:, k - zero_tail:] = 0.0
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1)), torch.from_numpy(scores)


def conv_inputs(n=2, h=9, w=7, c=20, o=12, kh=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8, generator=g)
    wq = torch.randint(-128, 128, (o, kh, kh, c), dtype=torch.int8, generator=g)
    a = torch.rand(o, generator=g) * 1e-3
    b = torch.randn(o, generator=g)
    return x, wq, a, b


def mm_inputs(m, k, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        return (torch.randint(-128, 128, (m, k), dtype=dtype, generator=g),
                torch.randint(-128, 128, (k, n), dtype=dtype, generator=g))
    return (torch.randn(m, k, generator=g).to(dtype), torch.randn(k, n, generator=g).to(dtype))


def _opcheck(op, args):
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("k, zero_tail, thr", [(37, 7, 0.45), (1, 0, 0.45), (64, 64, 0.3)])
def test_opcheck_greedy_nms_mask(k, zero_tail, thr):
    boxes, scores = nms_inputs(k=k, zero_tail=zero_tail)
    _opcheck(OPS.greedy_nms_mask.default, (boxes, scores, thr))
    keep = OPS.greedy_nms_mask(boxes, scores, thr)
    assert torch.equal(keep, cuda_nms.greedy_nms_mask_plain(boxes, scores, thr))
    assert not keep[:, k - zero_tail:].any()


@pytest.mark.parametrize("kh, stride, c, out_dtype", [
    (3, 2, 20, torch.int8), (3, 1, 20, torch.bfloat16), (1, 1, 12, torch.float32),
    (3, 2, 20, torch.int32)])
def test_opcheck_int8_conv(kh, stride, c, out_dtype):
    x, wq, a, b = conv_inputs(c=c, kh=kh)
    assert (kh * kh * c) % 16 != 0  # the weight map's padded copy on the card
    _opcheck(OPS.int8_conv.default, (x, wq, a, b, stride, True, cuda_conv.out_mode(out_dtype)))
    got = cuda_conv.int8_conv(x, wq, a, b, stride, True, out_dtype)
    want = cuda_conv.int8_conv_plain(x, wq, a, b, stride, True, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert got.shape == (2, cuda_conv.out_size(9, kh, stride), cuda_conv.out_size(7, kh, stride), 12)


@pytest.mark.parametrize("m, k, n, dtype", [(10, 48, 7, torch.int8), (33, 20, 5, torch.int8),
                                            (9, 24, 40, torch.bfloat16)])
def test_opcheck_matmul(m, k, n, dtype):
    a, b = mm_inputs(m, k, n, dtype)
    _opcheck(OPS.matmul.default, (a, b))
    assert torch.equal(cuda_matmul.matmul(a, b), cuda_matmul.matmul_plain(a, b))


@pytest.mark.parametrize("dy, dx", [(0, 0), (1, 2)])
def test_opcheck_matmul_nt_on_a_strided_tap(dy, dx):
    """The dots plan's operand: one tap of (O, 3, 3, C) weights, rows 9C
    apart. The op takes the view as it is and equals the product with a
    contiguous copy."""
    a, _ = mm_inputs(50, 48, 1, torch.int8)
    w = torch.randint(-128, 128, (6, 3, 3, 48), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(1))
    tap = w[:, dy, dx, :]
    assert tap.stride() == (9 * 48, 1)
    _opcheck(OPS.matmul_nt.default, (a, tap))
    assert torch.equal(cuda_matmul.matmul_nt(a, tap), cuda_matmul.matmul_nt(a, tap.contiguous()))


def test_every_op_is_tagged_to_keep_the_strides_eager_passes():
    """A compiled graph must hand each launcher the layouts an eager call
    does (the CUDA kernels refuse others): needs_exact_strides, not the
    build's default for custom ops."""
    for name in library.SCHEMAS:
        assert torch.Tag.needs_exact_strides in getattr(OPS, name).default.tags, name


def test_the_wrappers_call_the_ops():
    """A meta tensor has no kernel of its own: the wrappers reach the op,
    whose fake implementation answers."""
    boxes, scores = nms_inputs()
    keep = cuda_nms.greedy_nms_mask(boxes.to("meta"), scores.to("meta"), 0.45)
    assert keep.device.type == "meta" and keep.shape == scores.shape and keep.dtype == torch.bool
    x, wq, a, b = (t.to("meta") for t in conv_inputs())
    y = cuda_conv.int8_conv(x, wq, a, b, 2, True, torch.bfloat16)
    assert y.device.type == "meta" and y.shape == (2, 5, 4, 12) and y.dtype == torch.bfloat16
    am, bm = (t.to("meta") for t in mm_inputs(10, 48, 7, torch.int8))
    assert cuda_matmul.matmul(am, bm).dtype == torch.int32
    assert cuda_matmul.matmul_nt(am, bm.t()).shape == (10, 7)
    with pytest.raises(ValueError, match="channels"):
        cuda_conv.int8_conv(x[..., :4], wq, a, b, 1, True, torch.int8)


def _cpp_schemas(text):
    """The schema strings of every m.def(...) in a C++ source (adjacent
    string literals joined, as the compiler joins them)."""
    out = []
    for m in re.finditer(r'm\.def\(\s*((?:"(?:[^"\\]|\\.)*"\s*)+)', text):
        out.append("".join(re.findall(r'"((?:[^"\\]|\\.)*)"', m.group(1))))
    return out


def test_the_native_runner_registers_the_same_schemas():
    text = (ROOT / "yololp_tpu_torch/deploy/aoti_cpp/ops.cpp").read_text()
    assert _cpp_schemas(text) == list(library.SCHEMAS.values())
    assert "TORCH_LIBRARY(yololp_torch, m)" in text
    for name in ("greedy_nms_mask", "int8_conv"):
        assert f'm.impl("{name}"' in text
    assert text.count("needs_exact_strides") == len(library.SCHEMAS)
