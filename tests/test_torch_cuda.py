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
(|a| @ |b|) elementwise. Then chip_smoke.py's phase 12 at a small size (the
evaler on the card against the plain CPU NMS on its decode) and the loss on
the card against the CPU. nms_gate: chip_smoke.py's phase 27 cases (ties,
NaN rows, scores at the threshold and its fp32 neighbours, an odd row
count, an offset view, 8400 and 34000 anchors), every output equal to the
plain version's to the bit; select_candidates on the card launches it once
and raises on a decode it does not take.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (check_matmul, gate_decode, gate_edge_decode, gate_equal, int8_case,
                        int8_specs, mask_cases, matmul_cases, matmul_operands)
from yololp_tpu_torch.ops import cuda_conv, cuda_matmul, cuda_nms, cuda_nms_gate

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


@pytest.mark.cuda
def test_eval_on_the_card_equals_the_plain_nms_on_its_decode(cuda_device):
    """chip_smoke.py phase 12 at a small size: yololpn at 128 px, bf16, 10
    labelled frames in loader batches of 4 (a padded tail of 2)."""
    from chip_smoke import eval_on_card, labelled_frames, loader_batches, randomize_parameters
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.layers.fuse import fuse_model
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.utils.config import Config

    cfg = Config.named("yololpn")
    train = build_model(cfg, seed=0, device="cpu")
    randomize_parameters(train, torch.Generator().manual_seed(0))
    inf = Inferer(None, fuse_model(train).state_dict(), cfg, img_size=128, device=cuda_device)
    loader = loader_batches(*labelled_frames(np.random.default_rng(0), 10, 128), 4)
    ev = Evaler({}, batch_size=4, img_size=128, conf_thres=0.01, device=cuda_device)
    metric, launches, preds, own, _ = eval_on_card(ev, ev.make_infer_fn(inf.model), inf.model,
                                                   loader, (cuda_nms,))
    assert launches == {"cuda_nms": 3} and len(preds) == 10 and len(metric) == 7
    assert len(own) == 7


@pytest.mark.cuda
def test_loss_on_the_card_equals_the_cpu(cuda_device):
    """compute_loss on the card against the port on the CPU, on the same
    head outputs and padded targets: fg masks equal, items and total within
    rtol 1e-5, gradients within 1e-5 of their largest magnitude (reductions
    sum in other orders)."""
    from yololp_tpu_torch.losses.loss import LossConfig, compute_loss
    from yololp_tpu_torch.models.effidehead import HeadTrainOutput

    rng = np.random.default_rng(0)
    a = sum((128 // s) ** 2 for s in (8, 16, 32))
    outs = [rng.uniform(0.001, 0.999, s).astype(np.float32)
            for s in ((2, a, 31), (2, a, 24), (2, a, 6, 37))]
    outs += [rng.uniform(-2, 6, (2, a, 4)).astype(np.float32),
             rng.uniform(-4, 4, (2, a, 8)).astype(np.float32)]
    labels = np.zeros((2, 32, 20), np.float32)
    labels[..., :8] = -1
    mask = np.zeros((2, 32), np.float32)
    for b, n in enumerate((5, 2)):
        for i in range(n):
            cxy, wh = rng.uniform(0.2, 0.8, 2), rng.uniform(0.08, 0.4, 2)
            (x1, y1), (x2, y2) = cxy - wh / 2, cxy + wh / 2
            labels[b, i, :8] = rng.integers(0, 24, 8)
            labels[b, i, 8:20] = [*cxy, *wh, x1, y1, x1, y2, x2, y2, x2, y1]
            mask[b, i] = 1
    res = {}
    for dev in ("cpu", cuda_device):
        leaves = [torch.from_numpy(o).to(dev).requires_grad_(True) for o in outs]
        total, items, fg = compute_loss(HeadTrainOutput(None, *leaves), torch.from_numpy(labels),
                                        torch.from_numpy(mask), LossConfig(img_size=(128, 128)),
                                        with_fg=True)
        total.backward()
        res[str(dev)] = [t.detach().cpu() for t in [total, items, fg] + [x.grad for x in leaves]]
    cpu, card = res["cpu"], res[str(cuda_device)]
    assert torch.equal(card[2], cpu[2]) and cpu[2].sum() > 0
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(card[1], cpu[1], rtol=1e-5, atol=1e-7)
    for g, w in zip(card[3:], cpu[3:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("thres", [0.4, 0.7, 0.25])
def test_nms_gate_kernel_equals_plain_on_the_edges(thres, compat, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(27)
    gate_equal(gate_edge_decode(gen, cuda_device, thres), thres, compat, "edges")  # raises


@pytest.mark.cuda
@pytest.mark.parametrize("b, a", [(3, 517), (4, 8400), (1, 34000)])
def test_nms_gate_kernel_equals_plain(b, a, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(b * a)
    pred = gate_decode(b, a, gen, cuda_device)
    for compat in (False, True):
        gate_equal(pred, 0.4, compat, f"{b} x {a}")
    flat = pred.view(-1)[1:1 + (b * a - 1) * 290]  # 4 bytes past a 16-byte boundary
    gate_equal(flat.view(1, b * a - 1, 290), 0.4, False, "offset view")


@pytest.mark.cuda
def test_select_candidates_on_the_card_launches_the_gate_kernel_once(cuda_device):
    from yololp_tpu_torch.ops.nms import select_candidates

    gen = torch.Generator(device=cuda_device).manual_seed(28)
    pred = gate_decode(2, 8400, gen, cuda_device)
    cuda_nms_gate.launches = 0
    got = select_candidates(pred, 0.4, 512)
    torch.cuda.synchronize()
    assert cuda_nms_gate.launches == 1
    want = select_candidates(pred.cpu(), 0.4, 512)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    strided = torch.stack([pred, pred], 2).view(2, 2 * 8400, 290)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        select_candidates(strided, 0.4, 512)
    with pytest.raises(TypeError, match="float32"):
        select_candidates(pred.double(), 0.4, 512)


@pytest.mark.cuda
def test_nms_gate_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    pred = torch.zeros(2, 8, 290, device=cuda_device)
    for bad in (pred.double(), pred[..., :289], pred.transpose(0, 1)):
        with pytest.raises((ValueError, TypeError)):
            cuda_nms_gate.nms_gate(bad, 0.4)
    empty = cuda_nms_gate.nms_gate(pred[:, :0], 0.4)
    assert [t.shape for t in empty] == [(2, 0, 4), (2, 0), (2, 0, 24), (2, 0)]


@pytest.mark.cuda
def test_kernels_on_a_second_card_leave_the_callers_device(cuda_device):
    """Each ctypes launcher sets the device of its tensors; the wrapper puts
    the caller's current device back, so that what PyTorch does next (an
    event, a new tensor) stays on it. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    boxes, scores, thr = mask_cases(np.random.default_rng(1))["clustered_B32_K512"]
    b, s = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    for _ in range(2):  # the NMS launcher remembers the last device it set
        keep = cuda_nms.greedy_nms_mask(b, s, thr)
        assert torch.cuda.current_device() == 0
    assert torch.equal(keep.cpu(), cuda_nms.greedy_nms_mask_plain(b.cpu(), s.cpu(), thr))
    x, w, a, bias, stride, relu, dt = int8_case(np.random.default_rng(2),
                                                int8_specs()["int8_no_relu"])
    args = [torch.from_numpy(t).to(dev) for t in (x, w, a, bias)]
    got = cuda_conv.int8_conv(*args, stride, relu, dt)
    assert torch.cuda.current_device() == 0
    assert torch.equal(got, cuda_conv.int8_conv_plain(*args, stride, relu, dt))
    m, k, n, layout = matmul_cases()[MM_CASES[0]]
    a8, b8 = matmul_operands(np.random.default_rng(3), m, k, n, torch.int8, layout, dev)
    check_matmul(cuda_matmul, a8, b8, "on cuda:1", nt=layout != "kn")  # raises on a mismatch
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
