"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a card (the kernel has no CPU or
interpret mode). The machine with the card has no JAX, so run these there
without the JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

The cases are chip_smoke.py's. greedy_nms: clustered boxes at the main
path's B = 32, K = 512, a conf-gated zero tail, exact score ties, degenerate
boxes, a 128-deep chain, K = 1024, B = 1 and 128, K = 1, 300 and 1000, every
score 0 and a 512-deep chain across every band of rows; the keep-mask must
be equal, not close (`-k nms` selects these). int8_conv: every RepBlock
chain geometry of yololps at 640 (N = 32), a 3x3/s2, 1x1 with O = 277 and
12, int8 without relu, extreme codes, the accumulator, C = 32 (K = 288)
with M not a multiple of 128, a 3x3/s2 fp32 exit at O = 12 and a C that is
not a multiple of 16; equal to the bit.
mxu_matmul: the matmul probe's three shapes, ragged M, K and N, K = 288, a
conv9dots tap at the main path's N = 32, and `matmul_nt` on a strided tap
view of (O, 3, 3, C) weights; int8 equal, bf16 within 2 K 2**-24
(|a| @ |b|) elementwise.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (check_matmul, int8_case, int8_specs, mask_cases, matmul_cases,
                        matmul_operands)
from yololp_tpu_torch.ops import cuda_conv, cuda_matmul, cuda_nms

CASES = ["clustered_B32_K512", "conf_gated_zero_tail", "exact_score_ties",
         "degenerate_boxes", "chain_128_deep", "clustered_K1024", "B1_K512", "B128_K512", "K1",
         "K300_zero_tail", "K1000", "all_scores_zero", "chain_512_every_band"]


@pytest.fixture
def cuda_device():
    """The card; decided at run time, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_greedy_nms_kernel_equals_plain(case, cuda_device):
    boxes, scores, thr = mask_cases(np.random.default_rng(1))[case]
    b, s = torch.from_numpy(boxes).to(cuda_device), torch.from_numpy(scores).to(cuda_device)
    before = cuda_nms.launches
    got = cuda_nms.greedy_nms_mask(b, s, thr)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 1
    assert torch.equal(got.cpu(), cuda_nms.greedy_nms_mask_plain(b.cpu(), s.cpu(), thr))


@pytest.mark.cuda
def test_greedy_nms_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    boxes = torch.zeros(2, 8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="limit"):
        cuda_nms.greedy_nms_mask(torch.zeros(1, 1025, 4, device=cuda_device),
                                 torch.ones(1, 1025, device=cuda_device), 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nms.greedy_nms_mask(boxes.transpose(0, 1), torch.ones(8, 2, device=cuda_device), 0.45)
    empty = cuda_nms.greedy_nms_mask(boxes[:0], torch.ones(0, 8, device=cuda_device), 0.45)
    assert empty.shape == (0, 8)


INT8_CASES = list(int8_specs())


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_conv_kernel_equals_plain(case, cuda_device):
    x, w, a, b, stride, relu, dt = int8_case(np.random.default_rng(2), int8_specs()[case])
    args = [torch.from_numpy(t).to(cuda_device) for t in (x, w, a, b)]
    before = cuda_conv.launches
    got = cuda_conv.int8_conv(*args, stride, relu, dt)
    torch.cuda.synchronize()
    assert cuda_conv.launches == before + 1
    assert got.dtype == dt
    assert torch.equal(got, cuda_conv.int8_conv_plain(*args, stride, relu, dt))


@pytest.mark.cuda
def test_int8_conv_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 8, 32, dtype=torch.int8, device=cuda_device)
    w = torch.zeros(16, 3, 3, 32, dtype=torch.int8, device=cuda_device)
    a = torch.ones(16, device=cuda_device)
    with pytest.raises(TypeError, match="int8"):
        cuda_conv.int8_conv(x.float(), w, a, a)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv.int8_conv(x.permute(0, 2, 1, 3), w, a, a)
    with pytest.raises(TypeError, match="out_dtype"):
        cuda_conv.int8_conv(x, w, a, a, out_dtype=torch.float16)


MM_CASES = list(matmul_cases())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("case", MM_CASES)
def test_mxu_matmul_kernel_equals_plain(case, dtype, cuda_device):
    m, k, n, layout = matmul_cases()[case]
    a, b = matmul_operands(np.random.default_rng(3), m, k, n, dtype, layout, cuda_device)
    before = cuda_matmul.launches
    check_matmul(cuda_matmul, a, b, case, nt=layout != "kn")  # raises on a mismatch
    assert cuda_matmul.launches == before + 1


@pytest.mark.cuda
def test_mxu_matmul_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    a = torch.zeros(64, 32, dtype=torch.int8, device=cuda_device)
    b = torch.zeros(32, 16, dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError, match="int8"):
        cuda_matmul.matmul(a.float(), b.float())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_matmul.matmul(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="inner"):
        cuda_matmul.matmul(a, b.t().contiguous())
    assert torch.equal(cuda_matmul.matmul(a[:, :0], b[:0]),
                       torch.zeros(64, 16, dtype=torch.int32, device=cuda_device))
    # matmul_nt takes b_t's rows as they are: they must start on 16 bytes
    w = torch.zeros(16, 3, 3, 40, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_matmul.matmul_nt(torch.zeros(64, 48, dtype=torch.int8, device=cuda_device)[:, :40],
                              w[:, 1, 1, :])  # rows 360 bytes apart
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_matmul.matmul_nt(a, b.t())
