"""Port parity: the int8 conv (ops/cuda_conv.py), the RepBlock chains and the
whole int8 executor (quant/int8_infer.py) against yololp_tpu.

On the CPU the wrappers run the kernel's plain version (exact int32
accumulator, then the epilogue as a separate fp32 multiply and add). The JAX
side runs `conv3x3_int8_fused` in Pallas interpret mode, as
tests/test_pallas_conv.py does, and `_int8_conv` through XLA (its conv, or
with conv_impl "dots" its 9 shifted dots).

Tolerances: int32 accumulators and int8 codes exactly equal. A float output
within 1 fp32 ULP of the product acc * a (bounded by |y| + |b|), plus 1 bf16
ULP of y after the cast: XLA's CPU contracts the JAX epilogue `acc * a + b`
into an FMA, so it rounds the product once less than the port, which rounds
the multiply and the add separately (tests/test_pallas_conv.py:45-55 bounds
the same wobble). Where the bias cancels the product, one ULP of the product
is several ULPs of a small result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_quant import deploy_pair, frames, jax_amax
from yololp_tpu.ops import pallas_conv as jpc
from yololp_tpu.quant import int8_infer as jint8
from yololp_tpu_torch.ops import _build, cuda_conv, cuda_matmul
from yololp_tpu_torch.quant import int8_infer as tint8

torch.set_num_threads(2)


def rand_codes(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def to_t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_within_ulp(got, want, b, bf16=False):
    """|got - want| <= one fp32 ULP of |y| + |b| (the product's magnitude
    bound), plus one bf16 ULP of |y| for a bf16 output; b is the per-out-
    channel bias of the epilogue (the last axis)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.spacing((mag + np.abs(np.asarray(b, np.float32))).astype(np.float32))
    if bf16:
        ulp = ulp + np.spacing(mag) * 2.0 ** 16
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{bad.sum()} of {bad.size} beyond 1 ULP, max {np.abs(got - want).max()}"
    return float((got != want).mean())


# (name, N, H, C, O, K, stride): the chain link, the stride-2 downsample,
# the head's 1x1 preds with odd O, a C that is not a multiple of 16
GEOMS = [("3x3_s1", 2, 8, 64, 64, 3, 1), ("3x3_s2_odd", 2, 9, 32, 48, 3, 2),
         ("1x1_O277", 1, 5, 64, 277, 1, 1), ("1x1_O12", 2, 6, 32, 12, 1, 1),
         ("3x3_C24", 1, 7, 24, 40, 3, 1)]


@pytest.mark.parametrize("name,n,h,c,o,k,stride", GEOMS)
def test_accumulator_and_epilogue_match_jax(name, n, h, c, o, k, stride):
    rng = np.random.default_rng(len(name))
    x = rand_codes(rng, (n, h, h, c))
    w_hwio = rand_codes(rng, (k, k, c, o))
    w_q = w_hwio.transpose(3, 0, 1, 2)  # (O, KH, KW, C)
    a = (rng.random(o) * 2e-4 + 1e-6).astype(np.float32)
    b = (rng.standard_normal(o) * 3).astype(np.float32)
    pad = ((k // 2, k // 2),) * 2
    acc_j = np.asarray(jint8._int8_conv(jnp.asarray(x), jnp.asarray(w_hwio), (stride, stride), pad))
    acc_t = tint8._int8_conv(to_t(x), to_t(w_q), stride, k // 2)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), acc_j)
    assert np.abs(acc_j).max() > 2 ** 16

    yf = acc_j.astype(np.float32) * a + b  # numpy rounds the multiply and the add
    for relu, lo in ((True, 0), (False, -128)):
        q = cuda_conv.int8_conv(to_t(x), to_t(w_q), to_t(a), to_t(b), stride, relu, torch.int8)
        want = np.clip(np.round(yf), lo, 127).astype(np.int8)
        np.testing.assert_array_equal(q.numpy(), want)
        y32 = cuda_conv.int8_conv(to_t(x), to_t(w_q), to_t(a), to_t(b), stride, relu, torch.float32)
        want32 = np.maximum(yf, 0) if relu else yf
        np.testing.assert_array_equal(y32.numpy(), want32)
    # against the XLA epilogue, which may contract to an FMA
    want_j = np.asarray(jnp.asarray(acc_j).astype(jnp.float32) * a + b)
    got = cuda_conv.int8_conv(to_t(x), to_t(w_q), to_t(a), to_t(b), stride, False, torch.float32)
    assert_within_ulp(got.numpy(), want_j, b)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_fused_matches_pallas_interpret(relu):
    rng = np.random.default_rng(5)
    c = o = 64
    x = rand_codes(rng, (2, 8, 8, c))
    w9 = rand_codes(rng, (9, c, o))
    a = (rng.random(o) * 0.02 + 1e-4).astype(np.float32)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    args_j = (jnp.asarray(x), jnp.asarray(w9), jnp.asarray(a), jnp.asarray(b))
    args_t = (to_t(x), to_t(w9), to_t(a), to_t(b))
    want = np.asarray(jpc.conv3x3_int8_fused(*args_j, relu=relu, out_dtype=jnp.int8,
                                             interpret=True))
    got = cuda_conv.conv3x3_int8_fused(*args_t, relu=relu, out_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 if relu else want.min() < 0  # negative codes survive without relu
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want_f = np.asarray(jpc.conv3x3_int8_fused(*args_j, relu=relu, out_dtype=jdt,
                                                   interpret=True), np.float32)
        got_f = cuda_conv.conv3x3_int8_fused(*args_t, relu=relu, out_dtype=tdt)
        assert got_f.dtype == tdt
        assert_within_ulp(got_f.float().numpy(), want_f, b, bf16=tdt == torch.bfloat16)


def _chain_inputs(entry_int8, links=3, c=64, s=8):
    rng = np.random.default_rng(2)
    paths = [f"blk/link_{i}/conv" for i in range(links)]
    amax = {p: float(rng.random() * 4 + 2) for p in paths}
    raw = {p: (rand_codes(rng, (3, 3, c, c), -127, 128),
               (rng.random(c) * 0.01 + 1e-4).astype(np.float32),
               (rng.standard_normal(c) * 0.05).astype(np.float32)) for p in paths}
    table_j = {p: tuple(jnp.asarray(t) for t in e) for p, e in raw.items()}
    table_t = {p: (to_t(e[0].transpose(3, 0, 1, 2)), to_t(e[1]), to_t(e[2])) for p, e in raw.items()}
    if entry_int8:
        x = rng.integers(0, 128, (2, s, s, c)).astype(np.int8)
        return paths, amax, table_j, table_t, jnp.asarray(x), to_t(x)
    x = (rng.standard_normal((2, s, s, c)) * 0.5).astype(np.float32)
    return paths, amax, table_j, table_t, jnp.asarray(x), to_t(x)


@pytest.mark.parametrize("entry_int8", [False, True])
def test_chain_fused_matches_chain_repblock_pallas(entry_int8):
    paths, amax, table_j, table_t, xj, xt = _chain_inputs(entry_int8)
    kw_j = dict(out_dtype=jnp.float32) if entry_int8 else {}
    kw_t = dict(out_dtype=torch.float32) if entry_int8 else {}
    want = np.asarray(jpc.chain_repblock_pallas(xj, paths, amax, table_j, **kw_j))
    got = cuda_conv.chain_repblock_fused(xt, paths, amax, table_t, **kw_t)
    assert got.dtype == torch.float32
    assert_within_ulp(got.numpy(), want, table_t[paths[-1]][2])


@pytest.mark.parametrize("entry_int8", [False, True])
@pytest.mark.parametrize("exit_handoff", [False, True])
def test_chain_repblock_matches_jax(entry_int8, exit_handoff):
    paths, amax, table_j, table_t, xj, xt = _chain_inputs(entry_int8)
    exit_amax = 3.25 if exit_handoff else None
    kw_j = dict(out_dtype=jnp.float32, exit_amax=exit_amax)
    kw_t = dict(out_dtype=torch.float32, exit_amax=exit_amax)
    want = np.asarray(jint8._chain_repblock(xj, paths, amax, table_j, **kw_j))
    got = tint8._chain_repblock(xt, paths, amax, table_t, **kw_t)
    if exit_handoff:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert_within_ulp(got.numpy(), want, table_t[paths[-1]][2])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    w = torch.zeros(8, 3, 3, 8, dtype=torch.int8)
    a = torch.ones(8)
    with pytest.raises(TypeError, match="int8"):
        cuda_conv.int8_conv(x.float(), w, a, a)
    with pytest.raises(ValueError, match="1x1 and 3x3"):
        cuda_conv.int8_conv(x, torch.zeros(8, 5, 5, 8, dtype=torch.int8), a, a)
    with pytest.raises(ValueError, match="stride"):
        cuda_conv.int8_conv(x, w, a, a, stride=3)
    with pytest.raises(ValueError, match="cuda"):
        cuda_conv.int8_conv_cuda(x, w, a, a)


# ---------------- the whole int8 model ----------------

STRICT_SCORE, STRICT_PX = 1e-3, 0.05
# The reference is the jitted int8_apply, with the weights and the amax as
# trace-time constants (as make_int8_infer_fn runs it): its input quantizes
# multiply by the reciprocal scale, as the port does (ops/division.py). What
# is left between the two is XLA's FMA contraction of the epilogue
# `acc * a + b`, which can flip a rounding tie of an int8 code, and the flip
# propagates (tests/test_int8.py:106-112). This allowance is for that alone.
FLIP_SCORE, FLIP_PX = 0.05, 2.0


@pytest.fixture(scope="module")
def int8_setup():
    jmodel, fused, tmodel = deploy_pair()
    amax = jax_amax()
    x = frames(8, n=1).astype(np.float32) / 255.0
    return (jmodel, fused, tmodel, amax, jint8.quantize_kernels_int8(fused["params"]),
            tint8.quantize_kernels_int8(tmodel.state_dict()), x)


@pytest.mark.parametrize("conv_impl", ["conv", "pallas", "dots"])
@pytest.mark.parametrize("stage_handoffs", [True, False])
def test_int8_apply_matches_jax(int8_setup, conv_impl, stage_handoffs, monkeypatch):
    jmodel, fused, tmodel, amax, jtable, ttable, x = int8_setup
    want = np.asarray(jax.jit(lambda v: jint8.int8_apply(
        jmodel, fused, v, amax, jtable, train=False, conv_impl=conv_impl,
        stage_handoffs=stage_handoffs))(jnp.asarray(x)))
    links = []
    real = cuda_conv.run_chain
    monkeypatch.setattr(cuda_conv, "run_chain",
                        lambda x, s, lk: links.append(id(lk)) or real(x, s, lk))
    # the dots plan runs its chains' links as matmuls (tint8._dots_chain)
    real_dots = tint8._dots_chain
    monkeypatch.setattr(tint8, "_dots_chain",
                        lambda x, s, lk: links.append(id(lk)) or real_dots(x, s, lk))
    matmuls = []
    real_mm = cuda_matmul.matmul_nt
    monkeypatch.setattr(cuda_matmul, "matmul_nt", lambda a, b: matmuls.append(1) or real_mm(a, b))
    before = _build.launches("int8_conv")
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    model = tint8.build_int8_model(tmodel, amax, ttable, conv_impl=conv_impl,
                                   stage_handoffs=stage_handoffs)
    with torch.inference_mode():
        got = model(x_t).numpy()
    assert _build.launches("int8_conv") == before  # the CPU runs the plain version
    # only the dots plan reaches the matmul (9 a 3x3/s1 conv, 1 a 1x1/s1)
    assert bool(matmuls) == (conv_impl == "dots"), len(matmuls)
    # yololpn has 8 RepBlock chains; each must run as an int8 chain, by the
    # plan conv_impl selects (pallas: the fused plan, float exit)
    blocks = [m for m in model.modules() if isinstance(m, tint8.Int8RepBlock)]
    plan = [id((b.fused if conv_impl == "pallas" else b.plan)[1]) for b in blocks]
    assert len(blocks) == 8 and sorted(links) == sorted(plan), (len(links), len(blocks))
    torch.testing.assert_close(
        torch.from_numpy(got),
        tint8.int8_apply(tmodel, x_t, amax, ttable, conv_impl=conv_impl,
                         stage_handoffs=stage_handoffs), rtol=0, atol=0)
    assert got.shape == want.shape and np.isfinite(got).all()
    d_score = np.abs(got[..., 13:] - want[..., 13:])
    d_px = np.abs(got[..., :13] - want[..., :13])
    n_off = int((d_score > STRICT_SCORE).sum() + (d_px > STRICT_PX).sum())
    # seen on this seed: 3e-8 on scores and 0 px for every plan
    msg = (f"{n_off} decode values beyond {STRICT_SCORE} / {STRICT_PX} px (a flipped code); "
           f"max {d_score.max()} score, {d_px.max()} px")
    assert d_score.max() <= FLIP_SCORE and d_px.max() <= FLIP_PX, msg
    if n_off:
        pytest.fail(msg)


def test_int8_apply_tracks_the_fake_quant_simulation():
    """The per-conv int8 executor (no chains, no handoffs: every conv
    quantizes its own input, as the simulation does) against its oracle,
    the port's fake-quant simulation, on one deploy CSP-SPPF block in fp32:
    they differ only in how the conv sums (exact int32 against fp32), so
    within rtol 1e-4 / atol 1e-4. On a whole random-weight model an fp32
    last bit can flip a code and ~70 convs amplify it (the JAX package's own
    executor is 0.087 from its simulation on the weights used here)."""
    from test_torch_layers import nchw
    from yololp_tpu_torch.layers import blocks as tb
    from yololp_tpu_torch.quant import quantize as tq

    class Deploy(torch.nn.Module):
        def __init__(self, blk):
            super().__init__()
            self.deploy, self.blk = True, blk

        def forward(self, x):
            return self.blk(x)

    torch.manual_seed(0)
    model = Deploy(tb.SimCSPSPPF(16, 16, deploy=True)).eval()
    x = nchw(np.random.default_rng(9).standard_normal((2, 7, 7, 16)).astype(np.float32))
    amax = {p: 1.5 + 0.25 * i for i, (p, _) in enumerate(tq.quantizable_modules(model))}
    table = tint8.quantize_kernels_int8(model.state_dict())
    y_i8 = tint8.int8_apply(model, x, amax, table, chain_repblocks=False, stage_handoffs=False)
    with torch.inference_mode():
        y_fq = tq.quantized_apply(tq.quantize_weights(model), x, amax)
    assert len(table) == 7
    torch.testing.assert_close(y_i8, y_fq, rtol=1e-4, atol=1e-4)


def test_int8_model_swaps_every_calibrated_conv(int8_setup):
    _, _, tmodel, amax, _, ttable, _ = int8_setup
    m = tint8.build_int8_model(tmodel, amax, ttable)
    kinds = [type(x).__name__ for x in m.modules()]
    convs = [n for n, x in m.named_modules() if type(x) is torch.nn.Conv2d]
    assert convs == ["backbone.stem.conv"]  # skipped by default: a cuDNN float conv
    assert kinds.count("Int8RepBlock") == 8
    handed = [x for x in m.modules() if isinstance(x, tint8.Int8Conv2d) and x.handoff]
    assert len(handed) == len(tint8.graph_handoffs(amax, ttable))
    assert sum(isinstance(x, torch.nn.ConvTranspose2d) for x in m.modules()) == 2


def test_make_int8_infer_fn_raises_instead_of_falling_back(int8_setup, monkeypatch):
    _, _, tmodel, amax, _, _, x = int8_setup
    batch = (x * 255).round().astype(np.uint8)
    kw = dict(conf_thres=0.01, max_det=20, device="cpu")
    run = tint8.make_int8_infer_fn(tmodel, tmodel.state_dict(), amax, **kw)
    det, valid, num = run(batch)
    assert det.shape == (1, 20, 28) and int(num[0]) > 0
    pred = tint8.make_int8_infer_fn(tmodel, tmodel.state_dict(), amax, with_nms=False, **kw)(batch)
    ref = tint8.int8_apply(tmodel, torch.from_numpy(x).permute(0, 3, 1, 2), amax,
                           tint8.quantize_kernels_int8(tmodel.state_dict()))
    torch.testing.assert_close(pred, ref, rtol=0, atol=0)

    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("kernel refused")

    monkeypatch.setattr(cuda_conv, "int8_conv", broken)
    for _ in range(2):  # no permanent switch to another plan after a failure
        with pytest.raises(RuntimeError, match="kernel refused"):
            run(batch)
    assert len(calls) == 2
    with pytest.raises(ValueError, match="conv_impl"):
        tint8.make_int8_infer_fn(tmodel, tmodel.state_dict(), amax, conv_impl="xla", **kw)


def test_cli_int8_on_cpu_writes_labels(int8_setup, tmp_path):
    import cv2

    from yololp_tpu_torch.quant.quantize import calibrate, save_amax
    from yololp_tpu_torch.tools.infer import main

    src = tmp_path / "src"
    src.mkdir()
    imgs = frames(3, n=2)
    for i, im in enumerate(imgs):
        cv2.imwrite(str(src / f"im{i}.png"), im)
    from yololp_tpu_torch.core.inferer import Inferer

    inf = Inferer(str(src), None, "yololpn", img_size=64, half=False, device="cpu")
    save_amax(calibrate(inf.model, [imgs], device="cpu"), str(tmp_path / "amax.json"))
    for impl in ("conv", "pallas"):
        out = tmp_path / impl
        main(["--source", str(src), "--conf-file", "yololpn", "--img-size", "64",
              "--device", "cpu", "--conf-thres", "0.005", "--not-save-img", "--int8",
              "--calib-pt", str(tmp_path / "amax.json"), "--conv-impl", impl,
              "--project", str(out)])
        for i in range(2):
            assert (out / "exp" / "labels" / f"im{i}.txt").read_text(encoding="utf-8")
    with pytest.raises(SystemExit):
        main(["--source", str(src), "--device", "cpu", "--not-save-img", "--int8"])


# ---------------- the model zoo under --int8 ----------------


def _zoo_deploy_pair(name, seed=31):
    """(flax deploy module, fused variables, the port's deploy model) of a
    narrow zoo config on the same seeded weights."""
    from test_torch_zoo import narrow, random_jax_variables
    from yololp_tpu.layers.fuse import fuse_variables
    from yololp_tpu.models.yolo import Model as JModel
    from yololp_tpu.utils.config import Config as JConfig
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

    variables = random_jax_variables(Model(narrow(Config.named(name))), seed)
    fused = jax.tree_util.tree_map(np.asarray, jax.jit(fuse_variables)(variables))
    tmodel = load_state_dict_strict(Model(narrow(Config.named(name)), deploy=True),
                                    jax_to_state_dict(fused))
    return JModel(narrow(JConfig.named(name)), deploy=True), fused, tmodel.eval()


def test_zoo_int8_apply_matches_jax():
    """Narrow yolov6m (CSP backbone and neck, BottleRep stages, DFL head)
    under the conv plan against the jitted JAX int8_apply: the weight codes
    equal, no RepBlock chain (a BepC3's RepBlock of BottleReps runs conv by
    conv, as in JAX), every calibrated conv swapped, and the decode within
    the strict bounds of test_int8_apply_matches_jax."""
    from yololp_tpu_torch.quant import quantize as tq

    jmodel, fused, tmodel = _zoo_deploy_pair("yolov6m")
    x = frames(8, n=1).astype(np.float32) / 255.0
    amax = tq.calibrate(tmodel, [frames(7)], method="max", device="cpu")
    jtable = jint8.quantize_kernels_int8(fused["params"])
    ttable = tint8.quantize_kernels_int8(tmodel.state_dict())
    assert set(jtable) == set(ttable)
    for p, (wq, _, _) in ttable.items():
        if not p.endswith("upsample_transpose"):  # (a float conv in both)
            assert np.array_equal(wq.numpy(), np.asarray(jtable[p][0]).transpose(3, 0, 1, 2)), p
    want = np.asarray(jax.jit(lambda v: jint8.int8_apply(
        jmodel, fused, v, amax, jtable, train=False, conv_impl="conv"))(jnp.asarray(x)))
    model = tint8.build_int8_model(tmodel, amax, ttable, conv_impl="conv")
    assert not any(isinstance(m, tint8.Int8RepBlock) for m in model.modules())
    n_int8 = sum(isinstance(m, tint8.Int8Conv2d) for m in model.modules())
    assert n_int8 == sum(1 for p in amax if p in ttable and not p.endswith("upsample_transpose")
                         and not tq._skip(p, tq.DEFAULT_SKIP_SUBSTRINGS))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d_score = np.abs(got[..., 13:] - want[..., 13:]).max()
    d_px = np.abs(got[..., :13] - want[..., :13]).max()
    assert d_score <= STRICT_SCORE and d_px <= STRICT_PX, (d_score, d_px)


@pytest.mark.parametrize("name", ["yolov6m", "yolov6l", "yolov6m6", "yolov6n6",
                                  "repopt/yolov6n_hs", "base/yolov6s_base"])
def test_zoo_handoff_plans_match_jax(name):
    """The three planners on a CSP, conv_silu, P6, hyper-search and
    conv_relu graph emit exactly what the JAX planners emit (on the port's
    conv paths, which are the flax paths: tests/test_torch_configs.py)."""
    from test_torch_zoo import narrow
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.quant import quantize as tq
    from yololp_tpu_torch.utils.config import Config

    cfg = narrow(Config.named(name))
    with torch.device("meta"):
        model = Model(cfg, deploy=True)
    paths = [p for p, _ in tq.quantizable_modules(model)
             if not tq._skip(p, tq.DEFAULT_SKIP_SUBSTRINGS)]
    amax = {p: 1.0 for p in paths}
    table = {p: None for p in paths}
    relu = cfg.get("training_mode", "repvgg") != "conv_silu"
    got = tint8.graph_handoffs(amax, table, relu_acts=relu)
    assert got == jint8.graph_handoffs(amax, table, relu_acts=relu)
    assert tint8.backbone_handoffs(amax, table) == jint8.backbone_handoffs(amax, table)
    assert tint8.chain_exit_handoffs(amax, table) == jint8.chain_exit_handoffs(amax, table)
    if name == "yolov6l":
        # conv_silu: no handoff from a SiLU producer; BiFusion's convs are
        # ReLU in every family, so its cv2 -> downsample seams remain
        assert got and all("Bifusion" in p and p.endswith("/cv2/conv") for p in got)
