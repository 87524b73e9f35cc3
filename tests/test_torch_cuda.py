"""Every kernel against its plain version, on the card.

Marked `cuda`: each test skips without a card (a kernel has no CPU or
interpret mode). The machine with the card has no JAX, so run these there
without the JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

This is the card check of every kernel. Each op of ops/library.py is run
on every case of tests/kernel_cases.py through `torch.ops.yololp_torch`
(one launch a case) and held to its plain version: greedy_nms_mask, the
keep-mask equal; int8_conv, equal to the bit; matmul and matmul_nt, int8
equal and bf16 within 2 K 2**-24 (|a| @ |b|) elementwise; bias_act, none
and ReLU bit for bit and SiLU within 1 bf16 / 2 fp32 ulps of the plain
version and of PyTorch's unfused `add_` + activation, and its residual
form bit for bit with the plain form's kernel then PyTorch's alpha * x and
add, and with its plain version where the epilogues agree; nms_gate, every
output bit for bit (NaN too); quantize_codes, the codes bit for bit with
the input's strides. Each op refuses what its kernel does not
take, returns an empty output without a launch, and, on a second card,
leaves the caller's current device as it was. The residual form's
decomposition, as AOTInductor compiles it, equals the kernel bit for bit.
Then chip_smoke.py's phase
12 at a small size (the evaler on the card against the plain CPU NMS on
its decode), the loss on the card against the CPU, and select_candidates,
which launches the gate once and raises on a decode it does not take.
`-k greedy_nms_mask` (or any op's name) selects one op.
"""

import numpy as np
import pytest
import torch

from kernel_cases import (OPS, eval_on_card, gate_decode, labelled_frames, loader_batches,
                          randomize_parameters)
from yololp_tpu_torch.ops import _build, library

RECORDS = {op.name: op for op in library.RECORDS}
CASES = [(op, case) for op in RECORDS for case in OPS[op].cases()]
REFUSALS = [(op, i) for op in RECORDS for i in range(len(OPS[op].refusals))]


@pytest.fixture
def cuda_device():
    """The card; decided at run time, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def run_op(op, args):
    return getattr(torch.ops.yololp_torch, op)(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("op, case", CASES, ids=[f"{op}-{case}" for op, case in CASES])
def test_kernel_equals_its_plain_version(op, case, cuda_device):
    args = OPS[op].cases()[case](cuda_device)
    kernel = RECORDS[op].kernel
    before = _build.launches(kernel)
    got = run_op(op, args)
    torch.cuda.synchronize()
    assert _build.launches(kernel) == before + 1
    OPS[op].check(args, got, case)  # raises on a mismatch


@pytest.mark.cuda
@pytest.mark.parametrize("op, i", REFUSALS, ids=[f"{op}-{i}" for op, i in REFUSALS])
def test_the_op_refuses_what_the_kernel_does_not_take(op, i, cuda_device):
    make, err, match = OPS[op].refusals[i]
    with pytest.raises(err, match=match):
        run_op(op, make(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("op", list(RECORDS))
def test_an_empty_output_launches_nothing(op, cuda_device):
    args = OPS[op].empty(cuda_device)
    before = _build.launches(RECORDS[op].kernel)
    got, want = run_op(op, args), RECORDS[op].plain(*args)
    torch.cuda.synchronize()
    assert _build.launches(RECORDS[op].kernel) == before
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("op", list(RECORDS))
def test_kernels_on_a_second_card_leave_the_callers_device(op, cuda_device):
    """Each entry point sets the device of its tensors; the launch helper
    puts the caller's current device back, so that what PyTorch does next
    (an event, a new tensor) stays on it. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    case, make = next(iter(OPS[op].cases().items()))
    args = make(dev)
    for _ in range(2):  # the greedy_nms entry point remembers the last device it set
        got = run_op(op, args)
        assert torch.cuda.current_device() == 0
    OPS[op].check(args, got, f"{case} on cuda:1")
    torch.cuda.synchronize(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["repvgg", "conv_silu"])
def test_the_compiled_residual_form_equals_the_kernel(block, cuda_device, tmp_path):
    """export.compile_aoti compiles a deploy BottleRep, whose second conv's
    epilogue is the residual form, from the ops' plain versions
    (export.inductor_program). The package's output equals eager's, whose
    epilogues are the kernels, bit for bit: a rounding that Inductor drops
    (alpha * x's, the sum's or the epilogue's) moves many elements. The
    BottleRep follows a deploy block of its kind, as in every model: its
    shortcut is then a conv's epilogue output, which torch.export traces
    laid out as the conv outputs beside it (NCHW in torch 2.11's trace,
    whatever eager's cuDNN gives), where the graph's own channels_last
    input would not be, and the op would refuse it."""
    from yololp_tpu_torch.export.export import compile_aoti
    from yololp_tpu_torch.layers import blocks

    kind = {"repvgg": blocks.RepVGGBlock, "conv_silu": blocks.ConvWrapper}[block]
    gen = torch.Generator().manual_seed(29)
    m = torch.nn.Sequential(kind(64, 64, deploy=True),
                            blocks.BottleRep(64, 64, block=kind, weight=True, deploy=True)).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen) if name.endswith("alpha")
                    else 0.05 * torch.randn(p.shape, generator=gen))
    m = m.to(cuda_device, torch.bfloat16).to(memory_format=torch.channels_last)
    x = (2 * torch.randn(8, 64, 80, 80, generator=gen)).to(cuda_device, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    before = _build.launches("bias_act")
    with torch.no_grad():
        want = m(x)
        program = torch.export.export(m, (x,))
    assert _build.launches("bias_act") == before + 3  # two plain forms, then the residual form
    nodes = [n for n in program.graph.nodes if str(n.target) == "yololp_torch.bias_act.default"]
    assert [len(n.args) > 3 and n.args[3] is not None for n in nodes] == [False, False, True]
    path, _ = compile_aoti(program, str(tmp_path / "bottlerep.pt2"))
    package = torch._inductor.aoti_load_package(path)
    before = _build.launches("bias_act")
    with torch.no_grad():
        got = package(x)
    torch.cuda.synchronize()
    got = got[0] if isinstance(got, (tuple, list)) else got
    assert _build.launches("bias_act") == before  # Inductor's own passes, no kernel of ours
    assert torch.equal(got, want), f"{int((got != want).sum())} of {got.numel()} elements differ"


@pytest.mark.cuda
@pytest.mark.parametrize("name, residuals", [("yolov6m", 24), ("yolov6l6", 60)])
def test_a_csp_model_exports_on_the_card_with_its_residual_epilogues(name, residuals,
                                                                      cuda_device):
    """export.export_program of a CSP deploy model (Inferer.model, seeded
    weights) on the card at 128 px: every shortcut BottleRep's epilogue is
    a bias_act node with x and alpha, and the exported program's decode
    equals eager's bit for bit."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.export.export import build_export_fn, export_program

    torch.manual_seed(0)
    inf = Inferer(None, None, name, img_size=128, half=True, device=cuda_device)
    module = build_export_fn(inf.model, inf.variables, end2end=False)
    program = export_program(module, 2, 128, cuda_device)
    nodes = [n for n in program.graph.nodes if str(n.target) == "yololp_torch.bias_act.default"]
    assert sum(len(n.args) > 3 and n.args[3] is not None for n in nodes) == residuals
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    images = torch.randint(0, 256, (2, 128, 128, 3), generator=gen, device=cuda_device,
                           dtype=torch.uint8)
    with torch.no_grad():
        want, got = module(images), program.module()(images)
    for w, g in zip(*((want, got) if isinstance(want, tuple) else ((want,), (got,)))):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_eval_on_the_card_equals_the_plain_nms_on_its_decode(cuda_device):
    """chip_smoke.py phase 12 at a small size: yololpn at 128 px, bf16, 10
    labelled frames in loader batches of 4 (a padded tail of 2)."""
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
                                                   loader, ("greedy_nms",))
    assert launches == {"greedy_nms": 3} and len(preds) == 10 and len(metric) == 7
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
def test_select_candidates_on_the_card_launches_the_gate_kernel_once(cuda_device):
    from yololp_tpu_torch.ops.nms import select_candidates

    gen = torch.Generator(device=cuda_device).manual_seed(28)
    pred = gate_decode(2, 8400, gen, cuda_device)
    before = _build.launches("nms_gate")
    got = select_candidates(pred, 0.4, 512)
    torch.cuda.synchronize()
    assert _build.launches("nms_gate") == before + 1
    want = select_candidates(pred.cpu(), 0.4, 512)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    strided = torch.stack([pred, pred], 2).view(2, 2 * 8400, 290)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        select_candidates(strided, 0.4, 512)
    with pytest.raises(TypeError, match="float32"):
        select_candidates(pred.double(), 0.4, 512)




@pytest.mark.cuda
def test_the_int8_quantize_counts_its_kernel_launches(cuda_device):
    """`cuda_conv.quantize_codes` on the card: one `quantize` launch a
    non-empty input, counted in `int8.quantize_fused` while spans record;
    an empty input opens its span and launches nothing."""
    from torch.profiler import ProfilerActivity, profile

    from yololp_tpu_torch.ops import cuda_conv
    from yololp_tpu_torch.ops.cuda_quantize import quantize_codes_plain
    from yololp_tpu_torch.utils import profiler as P

    gen = torch.Generator(device=cuda_device).manual_seed(24)
    x = (2 * torch.randn(4, 32, 40, 40, generator=gen, device=cuda_device)).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    inv = cuda_conv.inv_host_scale(6.0)
    P.reset_spans()
    before = _build.launches("quantize")
    with profile(activities=[ProfilerActivity.CPU]):
        codes = [cuda_conv.quantize_codes(t, inv) for t in (x, x[:0], x[:2])]
    torch.cuda.synchronize()
    c, totals = P.counters(), P.span_totals()
    P.reset_spans()
    assert _build.launches("quantize") == before + 2
    assert c["int8.quantize_fused"] == 2 and totals["int8.quantize"]["count"] == 3
    assert c["int8.quantized"] == x.numel() + x[:2].numel()
    for t, got in zip((x, x[:0], x[:2]), codes):
        assert got.stride() == t.stride() and torch.equal(got, quantize_codes_plain(t, inv))
