"""Port parity: calibration, fake-quant, kernel quantization and the int8
handoff planners against yololp_tpu.quant.

Weights: every parameter of `yololpn` randomized from a seeded numpy
generator, fused by the JAX package and carried into the port's deploy model
with utils/convert.py. Inputs: seeded uint8 frames at 64 px, batch 2, fp32.

Tolerances: amax values within rtol 1e-4 (the two frameworks sum conv
products in other orders, a few 1e-6 relative over the ~70 convs); the numpy
amax reducers, fake_quant of the same fp32 array, and the int8 kernel codes
and scales exactly; the planners' maps exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_models import jax_variables
from yololp_tpu.layers.fuse import fuse_variables
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.quant import int8_infer as jint8
from yololp_tpu.quant import quantize as jq
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.quant import int8_infer as tint8
from yololp_tpu_torch.quant import quantize as tq
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)

SIZE = 64


@functools.lru_cache(maxsize=None)
def deploy_pair(name="yololpn", seed=23):
    """(flax deploy module, its fused variables, the port's deploy model)
    on the same randomized weights."""
    fused = jax.tree_util.tree_map(np.asarray, fuse_variables(jax_variables(name, seed)))
    jmodel = JModel(JConfig.named(name), deploy=True)
    tmodel = Model(Config.named(name), deploy=True)
    load_state_dict_strict(tmodel, jax_to_state_dict(fused))
    return jmodel, fused, tmodel.eval()


def frames(seed, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)


@functools.lru_cache(maxsize=None)
def jax_amax(seed=7):
    jmodel, fused, _ = deploy_pair()
    return jq.calibrate(jmodel, fused, [frames(seed)], method="max")


def test_calibrate_max_matches_jax():
    _, _, tmodel = deploy_pair()
    want = jax_amax()
    got = tq.calibrate(tmodel, [frames(7)], method="max", device="cpu")
    assert set(got) == set(want) and len(got) > 60
    assert not any(tq._skip(p, tq.DEFAULT_SKIP_SUBSTRINGS) for p in got)
    # transposed convs are observed too, as in the JAX calibrator
    assert any(p.endswith("upsample_transpose") for p in got)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-4, err_msg=p)


def _jax_conv_inputs(jmodel, fused, images_u8):
    """|input| of every calibrated conv of the jitted JAX forward (fp32)."""
    from flax import linen as fnn

    def forward(x):
        seen = {}

        def interceptor(next_fun, args, kwargs, context):
            if jq._is_quantizable(context):
                path = jq._module_path(context)
                if not jq._skip(path, jq.DEFAULT_SKIP_SUBSTRINGS):
                    seen[path] = jnp.abs(args[0].astype(jnp.float32))
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            jmodel.apply(fused, x, train=False)
        return seen

    x = jax.jit(lambda u: u.astype(jnp.float32) / jnp.asarray(255.0, jnp.float32))(images_u8)
    return jax.device_get(jax.jit(forward)(x))


def test_histogram_stats_match_jax():
    """Pass-2 histograms on the bins fixed by the JAX max pass. The binning
    is exact: the port's `histogram` of the JAX package's own conv inputs
    equals the jitted JAX histogram of every conv at tolerance 0. On the
    port's own conv inputs the totals are equal, and at most 1e-4 of all
    values (0.5% of any one conv's) sit in another bin: the two frameworks
    sum conv products in other orders, and an fp32 difference can move a
    value across a bin edge."""
    jmodel, fused, tmodel = deploy_pair()
    amax = jax_amax()
    want = jax.device_get(jq.make_calib_fn(jmodel, fused, mode="histogram",
                                           amax_by_path=amax)(jnp.asarray(frames(7))))
    inputs = _jax_conv_inputs(jmodel, fused, jnp.asarray(frames(7)))
    assert set(inputs) == set(want)
    for p, a in inputs.items():
        np.testing.assert_array_equal(tq.histogram(torch.from_numpy(np.array(a)), amax[p]).numpy(),
                                      np.asarray(want[p], np.float64), err_msg=p)
    got = tq.make_calib_fn(tmodel, mode="histogram", amax_by_path=amax)(frames(7))
    assert set(got) == set(want)
    moved = total = 0.0
    for p in want:
        w, g = np.asarray(want[p], np.float64), np.asarray(got[p], np.float64)
        assert g.sum() == w.sum(), p
        assert np.abs(g - w).sum() / 2 <= 5e-3 * w.sum(), p
        moved, total = moved + np.abs(g - w).sum() / 2, total + w.sum()
    assert moved <= 1e-4 * total, (moved, total)


@pytest.mark.parametrize("method", ["percentile", "entropy", "mse"])
def test_compute_amax_equals_jax(method):
    rng = np.random.default_rng(3)
    stats = {"a/conv": rng.gamma(2.0, 50.0, tq.HIST_BINS).round(),
             "b/conv": np.concatenate([rng.poisson(400, 300), np.zeros(tq.HIST_BINS - 300)])}
    top = {"a/conv": 3.5, "b/conv": 0.75}
    merged_t = tq.merge_calib_stats([stats, stats], mode="histogram")
    merged_j = jq.merge_calib_stats([stats, stats], mode="histogram")
    got = tq.compute_amax(merged_t, method=method, amax_by_path=top)
    want = jq.compute_amax(merged_j, method=method, amax_by_path=top)
    assert got == want


def test_save_and_load_amax_cross_packages(tmp_path):
    amax = jax_amax()
    jq.save_amax(amax, str(tmp_path / "j.json"))
    assert tq.load_amax(str(tmp_path / "j.json")) == amax
    tq.save_amax(amax, str(tmp_path / "t.json"))
    assert jq.load_amax(str(tmp_path / "t.json")) == amax


def test_fake_quant_and_quantize_weights_equal_jax():
    """Against the jitted JAX functions, as the package runs them:
    `quantized_apply`'s constant amax, and `quantize_weights` under jit (the
    QAT train step) with its traced per-channel amax (ops/division.py)."""
    x = np.random.default_rng(4).standard_normal((4, 33)).astype(np.float32) * 3
    want = np.asarray(jax.jit(lambda v: jq.fake_quant(v, jnp.asarray(2.5, jnp.float32)))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(tq.fake_quant(torch.from_numpy(x), 2.5).numpy(), want)

    _, fused, tmodel = deploy_pair()
    want_sd = jax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(jq.quantize_weights)(fused["params"]))})
    got_sd = tq.quantize_weights(tmodel).state_dict()
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v.numpy(), err_msg=k)


def test_quantized_apply_matches_jax():
    """Fake-quant simulation of one deploy CSP-SPPF block (seven 1x1 and 3x3
    convs, max-pools, concats) in fp32: within rtol 1e-4 / atol 1e-4, the
    conv-order tolerance of tests/test_torch_layers.py. A whole random-weight
    model is not compared: there an fp32 last-bit difference that moves one
    input across a rounding edge flips a code, and ~70 convs amplify it."""
    from test_torch_layers import init_flax, nchw, nhwc
    from yololp_tpu.layers import blocks as jb
    from yololp_tpu_torch.layers import blocks as tb

    x = np.random.default_rng(9).standard_normal((2, 7, 7, 16)).astype(np.float32)
    fm = jb.SimCSPSPPF(16, deploy=True)
    variables = init_flax(fm, [x], seed=11)
    tm = load_state_dict_strict(tb.SimCSPSPPF(16, 16, deploy=True),
                                jax_to_state_dict(variables)).eval()
    # amax per conv input, a little inside each input's range so the clip acts
    paths = [p for p, _ in tq.quantizable_modules(tm)]
    amax = {p: 1.5 + 0.25 * i for i, p in enumerate(paths)}
    qvars = {"params": jq.quantize_weights(variables["params"])}
    want = np.asarray(jq.quantized_apply(fm, qvars, jnp.asarray(x), amax))
    got = nhwc(tq.quantized_apply(tq.quantize_weights(tm), nchw(x), amax))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_quantize_kernels_int8_equal_jax():
    _, fused, tmodel = deploy_pair()
    want = jint8.quantize_kernels_int8(fused["params"])
    got = tint8.quantize_kernels_int8(tmodel.state_dict())
    assert set(got) == set(want)
    for p, (wq, ws, wb) in want.items():
        wq = np.asarray(wq)
        if p.endswith("upsample_transpose"):
            # torch's transposed kernel is the flax one flipped in space
            wq = wq[::-1, ::-1].transpose(3, 0, 1, 2)
        else:
            wq = wq.transpose(3, 0, 1, 2)  # HWIO -> (O, KH, KW, C)
        gq, gs, gb = got[p]
        assert gq.dtype == torch.int8
        np.testing.assert_array_equal(gq.numpy(), wq, err_msg=p)
        np.testing.assert_array_equal(gs.numpy().view(np.uint32),
                                      np.asarray(ws, np.float32).view(np.uint32), err_msg=p)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb, np.float32), err_msg=p)


def _planners(mod, amax, table, relu_acts=True):
    return (mod.backbone_handoffs(amax, table), mod.graph_handoffs(amax, table, relu_acts=relu_acts),
            mod.chain_exit_handoffs(amax, table))


def _conv_paths(name):
    """Calibratable conv paths of the port's deploy model, without running it."""
    model = Model(Config.named(name), deploy=True)
    return [p for p, _ in tq.quantizable_modules(model)
            if not tq._skip(p, tq.DEFAULT_SKIP_SUBSTRINGS)]


@pytest.mark.parametrize("name", ["yololpn", "yololps"])
@pytest.mark.parametrize("relu_acts", [True, False])
def test_planners_equal_jax(name, relu_acts):
    paths = _conv_paths(name)
    amax = {p: 1.0 for p in paths}
    table = {p: ("w", "s", "b") for p in paths}
    assert _planners(tint8, amax, table, relu_acts) == _planners(jint8, amax, table, relu_acts)
    # a path missing from the weight table or skipped drops its seams
    cut = dict(table)
    cut.pop("neck/reduce_layer0/conv")
    assert _planners(tint8, amax, cut, relu_acts) == _planners(jint8, amax, cut, relu_acts)
    skip = ("proj_conv", "backbone/stem", "ERBlock_3")
    assert (tint8.graph_handoffs(amax, table, skip) == jint8.graph_handoffs(amax, table, skip))


def test_planner_seams_on_calibrated_paths():
    """The seams tests/test_int8.py:222-242 asserts, on the port's own
    calibration of yololpn."""
    _, _, tmodel = deploy_pair()
    amax = tq.calibrate(tmodel, [frames(7)], device="cpu")
    table = tint8.quantize_kernels_int8(tmodel.state_dict())
    hand = tint8.graph_handoffs(amax, table)
    assert set(hand) > set(tint8.backbone_handoffs(amax, table))
    sppf = "backbone/ERBlock_5_sppf/"
    for a, b in (("cv1", "cv3"), ("cv3", "cv4"), ("cv4", "cv5"),
                 ("cv5", "cv6"), ("cv6", "cv7"), ("cv2", "cv7")):
        assert hand[f"{sppf}{a}/conv"] == f"{sppf}{b}/conv", (a, b)
    assert hand[f"{sppf}cv7/conv"] == "neck/reduce_layer0/conv"
    assert hand["neck/Bifusion0/cv2/conv"] == "neck/Bifusion0/downsample/conv"
    assert hand["neck/Bifusion1/cv2/conv"] == "neck/Bifusion1/downsample/conv"
    exits = tint8.chain_exit_handoffs(amax, table)
    assert "backbone/ERBlock_5_rep" not in exits
    assert exits["neck/Rep_p4"] == "neck/reduce_layer1/conv"
    assert exits["neck/Rep_n4"] == "detect/stem2/conv"
    assert "neck/Rep_p3" not in exits and "neck/Rep_n3" not in exits
    assert _planners(tint8, amax, table) == _planners(jint8, amax, table)
