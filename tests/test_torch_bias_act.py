"""The deploy convs' epilogue op, `yololp_torch::bias_act`
(yololp_tpu_torch/ops/cuda_bias_act.py), and its call site
`layers/blocks.py:conv_act`, on the CPU.

The op is held to PyTorch's unfused sequence, the one the card ran before
the op: the conv without its bias, `add_` of the broadcast bias in the
conv's dtype, then the activation. None and ReLU are equal bit for bit in
both dtypes (the same adds and the same selection). SiLU computes
v / (1 + exp(-v)) in fp32 on the rounded sum, where `F.silu` on the CPU
takes its own vectorized exp: within 2 ulps in fp32 and 1 in bf16
(measured over 7.1 M values: 4% of them 1-2 ulps apart in fp32, none in
bf16). Each case runs
four layouts: channels_last, a count that is not a multiple of the kernel's
8-element vector, an offset view that is not 16-byte aligned, and
contiguous NCHW. Besides: the fake's shape, dtype and strides, opcheck, an
exported deploy conv holds one op (which the AOTInductor program decomposes
into its plain arithmetic), the train graph keeps its gradient, the
counters a deploy model records (71 biased convs in yololps, 108 in
yolov6m, all fused) and the benchmark's reader of them. The residual
form, `bias_act(y, b, act, x, alpha)`, is held to the unfused sequence
after the epilogue, PyTorch's alpha * x and add, bit for bit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from yololp_tpu_torch.core.inferer import Inferer
from yololp_tpu_torch.export.export import inductor_program
from yololp_tpu_torch.layers import blocks
from yololp_tpu_torch.ops import cuda_bias_act
from yololp_tpu_torch.ops.cuda_bias_act import NONE, RELU, SILU
from yololp_tpu_torch.utils import profiler as P

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import spec as S  # noqa: E402
from kernel_cases import EPILOGUE_SHAPES, RESIDUAL_SHAPES  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_store():
    P.reset_spans()
    yield
    P.reset_spans()


ACTS = {NONE: lambda y: y, RELU: F.relu, SILU: F.silu}
# SiLU's tolerance in ulps of the dtype at the value (module docstring)
SILU_ULPS = {torch.float32: 2, torch.bfloat16: 1}


def conv_output(n, c, h, w, dtype, layout, seed):
    """(x, weight, bias, y): y the biased conv's output without its bias
    (what the unfused sequence then adds the bias to),
    in `layout`: "channels_last", "ragged" (N*H*W*C not a multiple of 8,
    channels_last), "offset" (a channels_last view 3 elements into a
    buffer, so not 16-byte aligned) or "nchw"."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 6, h, w, generator=g).to(dtype)
    weight = (torch.randn(c, 6, 3, 3, generator=g) * 0.4).to(dtype)
    bias = torch.randn(c, generator=g).to(dtype)
    if layout != "nchw":
        x = x.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, weight, None, 1, 1)
    if layout == "offset":
        buf = torch.empty(y.numel() + 3, dtype=dtype)
        view = buf[3:].view(n, h, w, c).permute(0, 3, 1, 2)
        view.copy_(y)
        assert view.data_ptr() % 16 and view.is_contiguous(memory_format=torch.channels_last)
        y = view
    return x, weight, bias, y


def ulps(got, want):
    """The largest |got - want| in units in the last place of `want`'s
    dtype at each element of `want` (2**floor(log2|want|) * eps)."""
    fi = torch.finfo(want.dtype)
    w = want.double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(fi.tiny)))) * fi.eps
    return ((got.double() - w).abs() / ulp).max().item()


@pytest.mark.parametrize("c", [8, 12, 76, 277])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", [NONE, RELU, SILU], ids=["none", "relu", "silu"])
def test_op_is_the_unfused_sequence(act, dtype, c):
    layouts = {"channels_last": (2, 8, 4), "ragged": (1, 3, 5), "offset": (2, 5, 3),
               "nchw": (2, 4, 6)}
    if c % 8 == 0:
        del layouts["ragged"]  # N * H * W * C is then a multiple of 8 whatever N, H, W
    for layout, (n, h, w) in layouts.items():
        x, weight, bias, y = conv_output(n, c, h, w, dtype, layout, seed=c + act)
        want = ACTS[act](y.clone().add_(bias.reshape(1, -1, 1, 1)))
        got = cuda_bias_act.bias_act(y, bias, act)
        assert got.dtype == dtype and got.shape == y.shape and got.data_ptr() != y.data_ptr()
        assert got.is_contiguous(memory_format=torch.channels_last if layout != "nchw"
                                 else torch.contiguous_format), layout
        if act == SILU:
            assert ulps(got, want) <= SILU_ULPS[dtype], layout
        else:
            assert torch.equal(got, want), layout


def test_fake_gives_shape_dtype_and_strides():
    with FakeTensorMode():
        for fmt in (torch.channels_last, torch.contiguous_format):
            y = torch.empty(2, 277, 5, 7, dtype=torch.bfloat16).contiguous(memory_format=fmt)
            out = torch.ops.yololp_torch.bias_act(y, torch.empty(277, dtype=torch.bfloat16), SILU)
            assert out.shape == y.shape and out.dtype == y.dtype and out.stride() == y.stride()


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_opcheck(layout):
    _, _, bias, y = conv_output(2, 12, 4, 5, torch.float32, layout, seed=1)
    result = torch.library.opcheck(torch.ops.yololp_torch.bias_act.default, (y, bias, RELU))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("bad, match", [
    (dict(b=torch.zeros(5)), "channels"), (dict(b=torch.zeros(4, dtype=torch.float64)), "alike"),
    (dict(act=3), "act"), (dict(y=torch.zeros(2, 4, 3, 3)[:, :, :, ::2]), "channels_last"),
    (dict(y=torch.zeros(2, 4, 3, 3, dtype=torch.float16), b=torch.zeros(4, dtype=torch.float16)),
     "alike"),
])
def test_refusals_raise(bad, match):
    args = dict(y=torch.zeros(2, 4, 3, 3), b=torch.zeros(4), act=RELU) | bad
    with pytest.raises((ValueError, TypeError), match=match):
        cuda_bias_act.bias_act(args["y"], args["b"], args["act"])


def test_export_of_a_deploy_conv_holds_one_op():
    m = blocks.ConvBNAct(8, 16, 3, 1, act="relu", deploy=True).eval()
    x = torch.randn(2, 8, 10, 10).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        program = torch.export.export(m, (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("yololp_torch.bias_act.default") == 1
    assert not [t for t in targets if "relu" in t or "add" in t]
    with torch.no_grad():
        assert torch.equal(program.module()(x), m(x))


def test_the_aoti_program_decomposes_the_epilogue():
    """AOTInductor compiles the epilogue from its plain arithmetic, which it
    fuses with the passes around it; the .pt2 keeps the op."""
    m = torch.nn.Sequential(blocks.ConvBNAct(8, 16, 3, 1, act="silu", deploy=True),
                            blocks.Transpose(16, 8)).eval()
    x = torch.randn(2, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        program = torch.export.export(m, (x,))
        decomposed = inductor_program(program)
        targets = [str(n.target) for n in decomposed.graph.nodes if n.op == "call_function"]
        assert not [t for t in targets if "yololp_torch" in t]
        assert [t for t in targets if "conv" in t] == ["aten.conv2d.default",
                                                       "aten.conv_transpose2d.input"]
        assert torch.equal(decomposed.module()(x), program.module()(x))


@pytest.fixture
def epilogues(monkeypatch):
    """The act number of each call of the op from layers/blocks.py."""
    seen, real = [], cuda_bias_act.bias_act
    monkeypatch.setattr(cuda_bias_act, "bias_act", lambda *a: seen.append(a[2]) or real(*a))
    return seen


def test_the_train_graph_keeps_its_gradient(epilogues):
    """With grad on, Transpose runs the biased transposed conv as autograd
    knows it: its bias gets its gradient. Under no_grad the op runs."""
    t = blocks.Transpose(4, 6)
    x = torch.randn(2, 4, 3, 5, requires_grad=True)
    t(x).sum().backward()
    assert torch.equal(t.upsample_transpose.bias.grad, torch.full((6,), 2.0 * 6 * 10))
    assert x.grad is not None and epilogues == []
    with torch.no_grad():
        fused = t(x)
    assert epilogues == [NONE]
    assert torch.allclose(fused, t.upsample_transpose(x), rtol=1e-6, atol=1e-6)


def test_each_activation_module_picks_its_epilogue(epilogues):
    with torch.no_grad():
        for act in ("relu", "silu", None):
            blocks.ConvBNAct(4, 4, 1, 1, act=act, deploy=True)(torch.randn(1, 4, 2, 2))
        blocks.RepVGGBlock(4, 4, deploy=True)(torch.randn(1, 4, 2, 2))
        blocks.LinearAddBlock(4, 4, deploy=True)(torch.randn(1, 4, 2, 2))
        blocks.ConvBNAct(4, 4, 1, 1, act="relu").eval()(torch.randn(1, 4, 2, 2))  # BN: none
    assert epilogues == [RELU, SILU, NONE, RELU, RELU]


def test_a_hooked_conv_sees_its_own_call():
    """Calibration's pre-hooks read each conv's input: a conv with a hook
    runs as itself (biased), so the hook fires, as it did before the op."""
    m = blocks.ConvBNAct(4, 4, 1, 1, act="relu", deploy=True)
    x = torch.randn(1, 4, 2, 2)
    fired = []
    h = m.conv.register_forward_pre_hook(lambda mod, args: fired.append(args[0].shape))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        m(x)
    h.remove()
    assert fired == [x.shape]
    assert P.counters() == {"conv.biased": 1}


@pytest.mark.parametrize("name, biased, residuals", [("yololps", 71, 0), ("yolov6m", 108, 24)])
def test_a_deploy_forward_counts_every_biased_conv_fused(name, biased, residuals, monkeypatch):
    """The counters of one deploy forward; its epilogues' distinct (C, stride,
    act) are the card cases' (tests/kernel_cases.py). yolov6m's 24 shortcut
    BottleReps take the residual form, yololps has none."""
    inferer = Inferer(None, None, name, img_size=64, half=False, conf_thres=0.0, max_det=4,
                      device="cpu")
    batch = np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3), np.uint8)
    calls = {"plain": [], "residual": []}  # the op's calls by form: without and with x
    real = cuda_bias_act.bias_act
    monkeypatch.setattr(cuda_bias_act, "bias_act", lambda y, b, act, x=None, alpha=None:
                        calls["plain" if x is None else "residual"].append(
                            (y.shape[1], 64 // y.shape[2], act)) or real(y, b, act, x, alpha))
    with profile(activities=[ProfilerActivity.CPU]):
        inferer.predict(batch)
    want = {"conv.biased": biased, "conv.epilogue_fused": biased,
            "decode.anchors": 8 * 8 + 4 * 4 + 2 * 2}
    if residuals:
        want |= {"block.residual": residuals, "block.residual_fused": residuals}
    assert P.counters() == want
    every = calls["plain"] + calls["residual"]
    assert len(calls["residual"]) == residuals and len(every) == biased
    assert sorted(set(every)) == EPILOGUE_SHAPES[name]
    assert sorted(set(calls["residual"])) == RESIDUAL_SHAPES.get(name, [])
    assert S.reader("conv_epilogue_fused.serve")({}) == 100.0
    assert S.reader("residual_fused.serve")({}) == (100.0 if residuals else None)


def test_the_reader_reads_a_share_and_nothing_from_an_empty_store():
    assert S.reader("conv_epilogue_fused.serve")({}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("conv.biased", 4)
        P.count("conv.epilogue_fused", 3)
    assert S.reader("conv_epilogue_fused.serve")({}) == 75.0
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("conv.biased", 2)  # a train-graph forward: none fused
    assert S.reader("conv_epilogue_fused.serve")({}) == 0.0
    m = {x["name"]: x for x in S.load(ROOT)["per_layer"]}["conv_epilogue_fused.serve"]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "program_counter", "model step", "images_per_s", "%")
    assert m["workloads"] == ["yololps-b128-dense", "yolov6m-b128-dense",
                              "yolov6l6-b32-1280-dense", "yololps-b128-int8-dense"]


# ---------------- the residual form, `bias_act(y, b, act, x, alpha)` ----------------


def residual_operands(n, c, h, w, dtype, layout, seed):
    """(y, b, x, alpha): conv_output's y and b, a block input x laid out as
    y (an offset view where y is one) and alpha drawn as the seeded weights
    draw it, N(1, 0.1)."""
    _, _, b, y = conv_output(n, c, h, w, dtype, layout, seed)
    g = torch.Generator().manual_seed(seed + 1)
    x = (torch.empty_like(y) if layout != "offset"
         else torch.empty(3 + y.numel(), dtype=dtype)[3:].view(n, h, w, c).permute(0, 3, 1, 2))
    x.copy_(torch.randn(n, c, h, w, generator=g))
    alpha = (1 + 0.1 * torch.randn(1, generator=g)).to(dtype)
    assert alpha.item() != 1
    return y, b, x, alpha


RESIDUAL_LAYOUTS = {"channels_last": (2, 16, 8, 4), "ragged": (1, 277, 3, 5),
                    "offset": (2, 12, 5, 3), "nchw": (2, 16, 4, 6)}


@pytest.mark.parametrize("layout", list(RESIDUAL_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", [NONE, RELU, SILU], ids=["none", "relu", "silu"])
def test_residual_op_is_the_unfused_sequence(act, dtype, layout):
    """The op is the epilogue's plain version, then alpha * x and the add in
    y's dtype, bit for bit; with none and ReLU, PyTorch's unfused add_ and
    activation too (SiLU's own ulps, test_op_is_the_unfused_sequence, grow
    in ulps of a sum that cancels)."""
    y, b, x, alpha = residual_operands(*RESIDUAL_LAYOUTS[layout], dtype, layout, seed=act + 5)
    got = cuda_bias_act.bias_act(y, b, act, x, alpha)
    assert got.dtype == dtype and got.shape == y.shape and got.stride() == y.stride()
    assert torch.equal(got, cuda_bias_act.bias_act_plain(y, b, act) + alpha * x)
    if act != SILU:
        assert torch.equal(got, ACTS[act](y.clone().add_(b.reshape(1, -1, 1, 1))) + alpha * x)


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_residual_fake_and_opcheck(layout):
    y, b, x, alpha = residual_operands(2, 12, 4, 5, torch.float32, layout, seed=1)
    result = torch.library.opcheck(torch.ops.yololp_torch.bias_act.default,
                                   (y, b, SILU, x, alpha))
    assert set(result.values()) == {"SUCCESS"}, result
    with FakeTensorMode() as mode:
        fy, fb, fx, fa = (mode.from_tensor(t) for t in (y, b, x, alpha))
        out = torch.ops.yololp_torch.bias_act(fy, fb, RELU, fx, fa)
    assert out.shape == y.shape and out.dtype == y.dtype and out.stride() == y.stride()


@pytest.mark.parametrize("bad, match", [
    (dict(x=torch.zeros(2, 4, 3, 2)), "shape"),
    (dict(x=torch.zeros(2, 4, 3, 3, dtype=torch.bfloat16)), "x and alpha must"),
    (dict(alpha=torch.ones(1, dtype=torch.float64)), "x and alpha must"),
    (dict(x=torch.zeros(2, 4, 3, 3).contiguous(memory_format=torch.channels_last)), "laid out"),
    (dict(alpha=torch.ones(2)), "one element"),
    (dict(alpha=torch.ones(1, device="meta")), "alpha on meta"),
    (dict(b=torch.zeros(5)), "channels"),  # the epilogue's own checks stand
    (dict(alpha=None), "together"),
], ids=["shape", "x_dtype", "alpha_dtype", "layout", "alpha_size", "device", "bias",
        "x_alone"])
def test_residual_refusals_raise(bad, match):
    args = dict(y=torch.zeros(2, 4, 3, 3), b=torch.zeros(4), act=RELU, x=torch.zeros(2, 4, 3, 3),
                alpha=torch.ones(1)) | bad
    with pytest.raises((ValueError, TypeError), match=match):
        cuda_bias_act.bias_act(*args.values())


def randomized_bottlerep(block, weight, dtype, seed=3):
    """A deploy BottleRep of 16 channels with N(0, 0.3) weights and biases
    and alpha from N(1, 0.1), in `dtype`."""
    torch.manual_seed(seed)
    m = blocks.BottleRep(16, 16, block=block, weight=weight, deploy=True).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(1 + 0.1 * torch.randn_like(p) if name == "alpha" else 0.3 * torch.randn_like(p))
    return m.to(dtype)


@pytest.fixture
def residual_calls(monkeypatch):
    """The act number of each call of the op's residual form from
    layers/blocks.py."""
    seen, real = [], cuda_bias_act.bias_act
    monkeypatch.setattr(cuda_bias_act, "bias_act", lambda y, b, act, x=None, alpha=None:
                        (x is not None and seen.append(act)) or real(y, b, act, x, alpha))
    return seen


@pytest.mark.parametrize("weight", [True, False], ids=["alpha", "no_alpha"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", [blocks.RepVGGBlock, blocks.ConvWrapper],
                         ids=["repvgg", "conv_silu"])
def test_a_deploy_bottlerep_takes_the_residual_form_bit_for_bit(block, dtype, weight,
                                                                 residual_calls):
    """Its second conv's epilogue adds the shortcut (alpha None reads as 1):
    equal to the unfused forward, conv2's output plus alpha * x."""
    m = randomized_bottlerep(block, weight, dtype)
    x = torch.randn(2, 16, 6, 5).to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = m.conv2(m.conv1(x))
        want = y + (m.alpha * x if weight else x)
        got = m(x)
    assert residual_calls == [RELU if block is blocks.RepVGGBlock else SILU]
    assert torch.equal(got, want) and got.stride() == want.stride()


def test_the_residual_takes_todays_path_where_the_op_does_not_take_it(residual_calls):
    """The train graph, a hooked second block, autocast, and a conv output
    laid out otherwise than the shortcut run conv2, then alpha * x and the
    add, as before the op; a hook fires."""
    x = torch.randn(1, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    train = blocks.BottleRep(16, 16, weight=True).eval()
    m = randomized_bottlerep(blocks.ConvWrapper, True, torch.float32)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        assert torch.equal(train(x), train.conv2(train.conv1(x)) + train.alpha * x)
        fired = []
        h = m.conv2.register_forward_hook(lambda *a: fired.append(1))
        assert torch.equal(m(x), m.conv2(m.conv1(x)) + m.alpha * x) and len(fired) == 2
        h.remove()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert torch.equal(m(x), m.conv2(m.conv1(x)) + m.alpha * x)
        conv, act = m.conv2.deploy_conv()
        nchw = x.contiguous()
        got = blocks.conv_act(conv, x, act, residual=nchw, alpha=m.alpha)
        assert torch.equal(got, m.conv2(x) + m.alpha * nchw)
    assert residual_calls == []
    assert P.counters()["block.residual"] == 3 and "block.residual_fused" not in P.counters()


@pytest.mark.parametrize("kind, err, match", [
    ("layout", ValueError, "laid out"),
    ("dtype", TypeError, "x and alpha must"),
])
def test_a_card_residual_always_takes_the_op(kind, err, match):
    """On the card no shortcut falls back to the unfused sequence: a conv
    output and shortcut the kernel does not take reach the op and raise (fake
    CUDA tensors here, which reach the op's fake; it checks as the kernel's
    wrapper does); a matching pair takes the op."""
    conv = torch.nn.Conv2d(16, 16, 3, padding=1, device="meta")
    with FakeTensorMode(), torch.no_grad():
        for name, p in conv.named_parameters():
            setattr(conv, name, torch.nn.Parameter(torch.empty(p.shape, device="cuda",
                                                               dtype=torch.bfloat16)))
        x = torch.empty(2, 16, 6, 5, device="cuda", dtype=torch.bfloat16,
                        memory_format=torch.channels_last)
        alpha = torch.empty(1, device="cuda", dtype=torch.bfloat16)
        y = conv._conv_forward(x, conv.weight, None)  # laid out as the fake conv chooses
        out = blocks.conv_act(conv, x, SILU, residual=torch.empty_like(y), alpha=alpha)
        assert out.device.type == "cuda" and out.stride() == y.stride()
        flip = (torch.contiguous_format if y.is_contiguous(memory_format=torch.channels_last)
                else torch.channels_last)
        other = (torch.empty_like(y, memory_format=flip) if kind == "layout"
                 else torch.empty_like(y, dtype=torch.float32))
        with pytest.raises(err, match=match):
            blocks.conv_act(conv, x, SILU, residual=other, alpha=alpha)


@pytest.mark.parametrize("name, img", [("yolov6m", 640), ("yolov6l6", 1280)])
def test_the_residual_shapes_are_the_models(name, img, monkeypatch):
    """A deploy forward on the meta device at the cell's size: 24 residual
    calls in yolov6m and 60 in yolov6l6, of the card cases' distinct (C,
    stride, act) (tests/kernel_cases.py)."""
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.utils.config import Config

    calls, real = [], cuda_bias_act.bias_act
    monkeypatch.setattr(cuda_bias_act, "bias_act", lambda y, b, act, x=None, alpha=None:
                        (x is not None and calls.append((y.shape[1], img // y.shape[2], act)))
                        or real(y, b, act, x, alpha))
    with torch.device("meta"):
        model = Model(Config.named(name), deploy=True).eval().to(torch.bfloat16)
    x = torch.empty(1, 3, img, img, device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        model(x.contiguous(memory_format=torch.channels_last))
    assert len(calls) == {"yolov6m": 24, "yolov6l6": 60}[name]
    assert sorted(set(calls)) == RESIDUAL_SHAPES[name]


def test_export_of_a_deploy_bottlerep_holds_the_residual_op_and_decomposes_it():
    """The exported graph holds two bias_act nodes, the second with the
    shortcut's x and alpha, and no add or mul; export.inductor_program
    writes both as their plain arithmetic, which gives the same bits."""
    m = randomized_bottlerep(blocks.ConvWrapper, True, torch.bfloat16)
    x = torch.randn(2, 16, 6, 6).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        program = torch.export.export(m, (x,))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        calls = [n for n in program.graph.nodes if str(n.target) == "yololp_torch.bias_act.default"]
        assert [len(n.args) > 3 and n.args[3] is not None for n in calls] == [False, True]
        assert not [t for t in targets if "add" in t or "mul" in t]
        decomposed = inductor_program(program)
        targets = [str(n.target) for n in decomposed.graph.nodes if n.op == "call_function"]
        assert not [t for t in targets if "yololp_torch" in t]
        assert torch.equal(decomposed.module()(x), program.module()(x))
        assert torch.equal(program.module()(x), m(x))


def test_the_residual_reader_reads_a_share_and_nothing_from_an_empty_store():
    assert S.reader("residual_fused.serve")({}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("block.residual", 4)
        P.count("block.residual_fused", 3)
    assert S.reader("residual_fused.serve")({}) == 75.0
    P.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("block.residual", 2)  # a train-graph forward: none fused
    assert S.reader("residual_fused.serve")({}) == 0.0
    m = {x["name"]: x for x in S.load(ROOT)["per_layer"]}["residual_fused.serve"]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "program_counter", "model step", "images_per_s", "%")
    assert m["workloads"] == ["yolov6m-b128-dense", "yolov6l6-b32-1280-dense"]
