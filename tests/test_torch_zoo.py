"""Port parity for the model zoo: every block class of the five training
modes with its fusion, and one model per backbone/neck pair, against flax.

Blocks: as tests/test_torch_layers.py (fp32, rtol = atol = 1e-5; the port's
fused weights equal `fuse_variables` within 1e-6). Models (`check_family`,
used here and by tests/test_torch_{zoo_p6,repopt}.py): narrow copies of
`FAMILY_REPS` of tests/test_configs.py, of yolov6m6 and of the conv_silu
yolov6l and yolov6l6 (width_multiple <= 0.25, depth_multiple 0.33) at 64
px, 128 for P6, every parameter and BN
statistic drawn from a seed, held to `assert_decode_close` of
tests/test_torch_models.py in the train graph and in the deploy graph after
each package's own fusion, whose weights agree within 1e-6. The two necks no
config reaches (RepPANNeck6, CSPRepPANNeck_P6) are built through a config
override.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_layers import (ATOL, RTOL, _apply_flax, _apply_torch, _inputs, init_flax, nchw,
                               randomize_variables)
from test_torch_models import assert_decode_close
from yololp_tpu.layers import blocks as jb
from yololp_tpu.layers.fuse import fuse_variables
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.layers import blocks as tb
from yololp_tpu_torch.layers.fuse import fuse_model, fuse_state_dict
from yololp_tpu_torch.models.yolo import BACKBONES, NECKS, Model, init_parameters
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import (jax_to_state_dict, load_state_dict_strict,
                                            state_dict_to_jax)

torch.set_num_threads(2)

# name -> (flax factory(deploy), torch factory(deploy), input NHWC shapes)
ZOO_CASES = {
    "realvgg": (lambda d: jb.RealVGGBlock(16, deploy=d),
                lambda d: tb.RealVGGBlock(8, 16, deploy=d), [(2, 9, 9, 8)]),
    "realvgg_s2": (lambda d: jb.RealVGGBlock(8, stride=2, deploy=d),
                   lambda d: tb.RealVGGBlock(8, 8, stride=2, deploy=d), [(1, 11, 13, 8)]),
    "linear_add_identity": (lambda d: jb.LinearAddBlock(8, deploy=d),
                            lambda d: tb.LinearAddBlock(8, 8, deploy=d), [(2, 8, 8, 8)]),
    "linear_add_s2": (lambda d: jb.LinearAddBlock(16, stride=2, deploy=d),
                      lambda d: tb.LinearAddBlock(8, 16, stride=2, deploy=d), [(2, 11, 9, 8)]),
    "linear_add_widen": (lambda d: jb.LinearAddBlock(16, deploy=d),
                         lambda d: tb.LinearAddBlock(8, 16, deploy=d), [(1, 6, 6, 8)]),
    "conv_wrapper_s2": (lambda d: jb.ConvWrapper(16, stride=2, deploy=d),
                        lambda d: tb.ConvWrapper(8, 16, stride=2, deploy=d), [(2, 9, 9, 8)]),
    "simconv_wrapper": (lambda d: jb.SimConvWrapper(8, deploy=d),
                        lambda d: tb.SimConvWrapper(8, 8, deploy=d), [(2, 7, 7, 8)]),
    "bottlerep_weighted": (lambda d: jb.BottleRep(8, weight=True, deploy=d),
                           lambda d: tb.BottleRep(8, 8, weight=True, deploy=d), [(2, 6, 6, 8)]),
    "bottlerep_plain": (lambda d: jb.BottleRep(8, deploy=d),
                        lambda d: tb.BottleRep(8, 8, deploy=d), [(1, 6, 6, 8)]),
    "bottlerep_widen": (lambda d: jb.BottleRep(16, weight=True, deploy=d),
                        lambda d: tb.BottleRep(8, 16, weight=True, deploy=d), [(1, 6, 6, 8)]),
    "repblock_bottlerep_n5": (
        lambda d: jb.RepBlock(16, n=5, block=jb.BottleRep, deploy=d),
        lambda d: tb.RepBlock(8, 16, n=5, block=tb.BottleRep, deploy=d), [(2, 6, 6, 8)]),
    "bepc3": (lambda d: jb.BepC3(16, n=4, deploy=d),
              lambda d: tb.BepC3(8, 16, n=4, deploy=d), [(2, 8, 8, 8)]),
    "bepc3_silu": (lambda d: jb.BepC3(16, n=2, block=jb.ConvWrapper, deploy=d),
                   lambda d: tb.BepC3(8, 16, n=2, block=tb.ConvWrapper, deploy=d),
                   [(1, 8, 8, 8)]),
    "bepc3_relu_wrapper_no_concat": (
        lambda d: jb.BepC3(16, n=2, e=0.75, concat=False, block=jb.SimConvWrapper, deploy=d),
        lambda d: tb.BepC3(8, 16, n=2, e=0.75, concat=False, block=tb.SimConvWrapper,
                           deploy=d), [(1, 8, 8, 8)]),
}


@pytest.mark.parametrize("name", sorted(ZOO_CASES))
def test_zoo_block_train_and_deploy_graphs_match_flax(name):
    make_j, make_t, shapes = ZOO_CASES[name]
    xs = _inputs(shapes, 1)
    fm = make_j(False)
    variables = init_flax(fm, xs, seed=zlib.crc32(name.encode()))
    want = _apply_flax(fm, variables, xs)
    tm = load_state_dict_strict(make_t(False), jax_to_state_dict(variables)).eval()
    np.testing.assert_allclose(_apply_torch(tm, xs), want, rtol=RTOL, atol=ATOL)
    # written back, the port's tree is the flax tree leaf for leaf
    back = state_dict_to_jax(tm.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, variables)))

    fused_j = jax.tree_util.tree_map(np.asarray, fuse_variables(variables))
    fused_t = fuse_state_dict(jax_to_state_dict(variables))
    want_sd = jax_to_state_dict(fused_j)
    assert set(fused_t) == set(want_sd)
    for k in want_sd:
        np.testing.assert_allclose(fused_t[k].numpy(), want_sd[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    td = load_state_dict_strict(make_t(True), fused_t).eval()
    np.testing.assert_allclose(_apply_torch(td, xs), _apply_flax(make_j(True), fused_j, xs),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_apply_torch(td, xs), want, rtol=1e-4, atol=1e-4)


def test_registries_hold_every_backbone_and_neck():
    from yololp_tpu.models.yolo import BACKBONES as JB, NECKS as JN

    assert set(BACKBONES) == set(JB) and len(BACKBONES) == 4
    assert set(NECKS) == set(JN) and len(NECKS) == 8


def narrow(cfg, override=None):
    """A narrow copy of a config (width <= 0.25, depth 0.33), with
    `override` {(section, key): value} applied to its model dict."""
    m = cfg["model"]
    m["width_multiple"] = min(m["width_multiple"], 0.25)
    m["depth_multiple"] = 0.33
    for (section, key), value in (override or {}).items():
        m[section][key] = value
    return cfg


def random_jax_variables(model, seed):
    """Seeded flax-form variables of a port model, through convert.py (the
    bases of the biases, scales and alphas from the seeded init)."""
    init_parameters(model, torch.Generator().manual_seed(0))
    return randomize_variables(state_dict_to_jax(model.state_dict()), seed)


# one model per backbone/neck pair: the family representatives of
# tests/test_configs.py but yololpn (tests/test_torch_models.py), yolov6m6
# for the CSP P6 pair, the two necks no config reaches, and yolov6l and
# yolov6l6 for the conv_silu mode (SiLU ConvWrapper blocks, the SiLU
# SPPF/CSPSPPF of the P5 backbone, the ReLU SPPF of the P6 one). The RepOpt
# families run in tests/test_torch_repopt.py, the P6 ones in
# tests/test_torch_zoo_p6.py (each file stays under a minute).
FAMILIES = {
    "yolov6m": ("yolov6m", None),
    "yolov6s_base": ("base/yolov6s_base", None),
    "yolov6l": ("yolov6l", None),
    "yolov6_tiny_hs": ("repopt/yolov6_tiny_hs", None),
    "yolov6n_opt": ("repopt/yolov6n_opt", None),
    "yolov6n6": ("yolov6n6", None),
    "yolov6m6": ("yolov6m6", None),
    "yolov6l6": ("yolov6l6", None),
    "RepPANNeck6": ("yolov6n6", {("backbone", "fuse_P2"): False, ("neck", "type"): "RepPANNeck6"}),
    "CSPRepPANNeck_P6": ("yolov6m6", {("backbone", "fuse_P2"): False,
                                      ("neck", "type"): "CSPRepPANNeck_P6"}),
}


@pytest.mark.parametrize("family", ["yolov6m", "yolov6s_base", "yolov6l"])
def test_family_matches_flax(family):
    check_family(*FAMILIES[family])


def check_family(name, override):
    """A narrow config's train and deploy forwards against flax, and the
    port's fused weights against `fuse_variables`."""
    jcfg, cfg = narrow(JConfig.named(name), override), narrow(Config.named(name), override)
    size = 128 if cfg["model"]["head"]["num_layers"] == 4 else 64
    x = np.random.default_rng(5).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    model = Model(cfg)
    variables = random_jax_variables(model, zlib.crc32(name.encode()))
    model = load_state_dict_strict(model, jax_to_state_dict(variables)).eval()
    jm = JModel(jcfg)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    strides = (8, 16, 32, 64) if size == 128 else (8, 16, 32)
    assert got.shape == (1, sum((size // s) ** 2 for s in strides), 290)
    assert_decode_close(got, want)

    fused = jax.tree_util.tree_map(np.asarray, jax.jit(fuse_variables)(variables))
    deploy = fuse_model(model)
    for k, v in jax_to_state_dict(fused).items():
        np.testing.assert_allclose(deploy.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    jd = JModel(jcfg, deploy=True)
    want_d = np.asarray(jax.jit(jd.apply)(fused, jnp.asarray(x)))
    with torch.no_grad():
        assert_decode_close(deploy(nchw(x)).numpy(), want_d)
