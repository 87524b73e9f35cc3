"""The greedy-NMS CUDA kernel against its plain version, on the card.

Marked `cuda`: each test skips without a card (the kernel has no CPU or
interpret mode). The machine with the card has no JAX, so run these there
without the JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

The cases are chip_smoke.py's: clustered boxes at the main path's B = 32,
K = 512, a conf-gated zero tail, exact score ties, degenerate boxes, a
128-deep chain and K = 1024. The keep-mask must be equal, not close.
"""

import numpy as np
import pytest
import torch

from chip_smoke import mask_cases
from yololp_tpu_torch.ops import cuda_nms

CASES = ["clustered_B32_K512", "conf_gated_zero_tail", "exact_score_ties",
         "degenerate_boxes", "chain_128_deep", "clustered_K1024"]


@pytest.fixture
def cuda_device():
    """The card; decided at run time, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_equals_plain(case, cuda_device):
    boxes, scores, thr = mask_cases(np.random.default_rng(1))[case]
    b, s = torch.from_numpy(boxes).to(cuda_device), torch.from_numpy(scores).to(cuda_device)
    before = cuda_nms.launches
    got = cuda_nms.greedy_nms_mask(b, s, thr)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 1
    assert torch.equal(got.cpu(), cuda_nms.greedy_nms_mask_plain(b.cpu(), s.cpu(), thr))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    boxes = torch.zeros(2, 8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="limit"):
        cuda_nms.greedy_nms_mask(torch.zeros(1, 1025, 4, device=cuda_device),
                                 torch.ones(1, 1025, device=cuda_device), 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nms.greedy_nms_mask(boxes.transpose(0, 1), torch.ones(8, 2, device=cuda_device), 0.45)
    empty = cuda_nms.greedy_nms_mask(boxes[:0], torch.ones(0, 8, device=cuda_device), 0.45)
    assert empty.shape == (0, 8)
