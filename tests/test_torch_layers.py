"""Port parity: each block against its flax counterpart, train and deploy graphs.

Every parameter and BN statistic is drawn from a seeded numpy generator
(`randomize_variables`) and carried into the port with utils/convert.py, so
the comparison is weight for weight. Tolerance: fp32 with a relative 1e-5
and an absolute 1e-5 — the two frameworks sum conv products in different
orders, which moves the last bits (~1e-7 relative per conv) and nothing
else. The port's fusion must give the same deploy weights as the JAX
`fuse_variables` within fp32 rounding (1e-6).
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.layers import blocks as jb
from yololp_tpu.layers.fuse import fuse_variables
from yololp_tpu.models.effidehead import Detect as JDetect
from yololp_tpu_torch.layers import blocks as tb
from yololp_tpu_torch.layers.fuse import fuse_state_dict
from yololp_tpu_torch.models.effidehead import Detect as TDetect
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
KERNEL_GAIN = 0.7  # keeps activations O(1..100) through the ~70 convs of a model


def randomize_variables(tree, seed, _name=None):
    """Replace every leaf of a JAX variable tree with seeded random values:
    He-style kernels (std KERNEL_GAIN/sqrt(fan_in)), BN scale and variance in
    [0.5, 1.5], BN shift and mean ~N(0, 0.1), conv biases = init + N(0, 0.1)
    (so the head keeps its prior-prob cls bias and unit reg bias)."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    if isinstance(tree, dict):
        return {k: randomize_variables(v, rng, k) for k, v in tree.items()}
    x = np.asarray(tree, np.float32)
    if _name == "kernel":
        std = KERNEL_GAIN / np.sqrt(np.prod(x.shape[:-1]))
        return (rng.standard_normal(x.shape) * std).astype(np.float32)
    if _name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    if _name in ("mean",):
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)


def init_flax(module, args, seed):
    args = jax.tree_util.tree_map(jnp.asarray, args)
    variables = module.init(jax.random.PRNGKey(0), *args)
    return randomize_variables(jax.tree_util.tree_map(np.asarray, variables), seed)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# name -> (flax factory(deploy), torch factory(deploy), input NHWC shapes)
CASES = {
    "conv_silu_1x1": (lambda d: jb.ConvBNAct(12, 1, 1, deploy=d),
                      lambda d: tb.ConvBNAct(8, 12, 1, 1, deploy=d), [(2, 9, 9, 8)]),
    "simconv_3x3_s2_odd": (lambda d: jb.SimConv(16, 3, 2, deploy=d),
                           lambda d: tb.SimConv(8, 16, 3, 2, deploy=d), [(2, 11, 13, 8)]),
    "conv_bias_and_bn": (lambda d: jb.ConvBNAct(8, 3, 1, conv_bias=True, deploy=d),
                         lambda d: tb.ConvBNAct(8, 8, 3, 1, conv_bias=True, deploy=d),
                         [(1, 8, 8, 8)]),
    "repvgg_identity": (lambda d: jb.RepVGGBlock(8, deploy=d),
                        lambda d: tb.RepVGGBlock(8, 8, deploy=d), [(2, 10, 10, 8)]),
    "repvgg_s2": (lambda d: jb.RepVGGBlock(16, stride=2, deploy=d),
                  lambda d: tb.RepVGGBlock(8, 16, stride=2, deploy=d), [(2, 13, 11, 8)]),
    "repvgg_widen": (lambda d: jb.RepVGGBlock(16, deploy=d),
                     lambda d: tb.RepVGGBlock(8, 16, deploy=d), [(1, 8, 8, 8)]),
    "repblock_n3": (lambda d: jb.RepBlock(16, n=3, deploy=d),
                    lambda d: tb.RepBlock(8, 16, n=3, deploy=d), [(2, 8, 8, 8)]),
    "simsppf": (lambda d: jb.SimSPPF(16, deploy=d),
                lambda d: tb.SimSPPF(16, 16, deploy=d), [(2, 7, 7, 16)]),
    "sppf_silu": (lambda d: jb.SPPF(16, deploy=d),
                  lambda d: tb.SPPF(16, 16, deploy=d), [(1, 6, 6, 16)]),
    "simcspsppf": (lambda d: jb.SimCSPSPPF(16, deploy=d),
                   lambda d: tb.SimCSPSPPF(16, 16, deploy=d), [(2, 7, 7, 16)]),
    "cspsppf_silu": (lambda d: jb.CSPSPPF(16, deploy=d),
                     lambda d: tb.CSPSPPF(16, 16, deploy=d), [(1, 6, 6, 16)]),
    "bifusion": (lambda d: jb.BiFusion(8, deploy=d),
                 lambda d: tb.BiFusion((16, 12, 4), 8, deploy=d),
                 [(2, 4, 4, 16), (2, 8, 8, 12), (2, 16, 16, 4)]),
}


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _flax_args(module, xs):
    """BiFusion takes its three maps as one list, every other block one map."""
    return [xs] if isinstance(module, jb.BiFusion) else xs


def _apply_flax(module, variables, xs):
    args = _flax_args(module, [jnp.asarray(x) for x in xs])
    return np.asarray(module.apply(variables, *args))


def _apply_torch(module, xs):
    with torch.no_grad():
        if isinstance(module, tb.BiFusion):
            return nhwc(module([nchw(x) for x in xs]))
        return nhwc(module(*[nchw(x) for x in xs]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_train_and_deploy_graphs_match_flax(name):
    make_j, make_t, shapes = CASES[name]
    xs = _inputs(shapes, 1)
    fm = make_j(False)
    variables = init_flax(fm, _flax_args(fm, xs), seed=zlib.crc32(name.encode()))
    want = _apply_flax(fm, variables, xs)

    tm = load_state_dict_strict(make_t(False), jax_to_state_dict(variables)).eval()
    np.testing.assert_allclose(_apply_torch(tm, xs), want, rtol=RTOL, atol=ATOL)

    # deploy graph: the port's fusion vs fuse_variables, weights and outputs
    fused_j = jax.tree_util.tree_map(np.asarray, fuse_variables(variables))
    fused_t = fuse_state_dict(jax_to_state_dict(variables))
    want_sd = jax_to_state_dict(fused_j)
    assert set(fused_t) == set(want_sd)
    for k in want_sd:
        np.testing.assert_allclose(fused_t[k].numpy(), want_sd[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    want_d = _apply_flax(make_j(True), fused_j, xs)
    td = load_state_dict_strict(make_t(True), fused_t).eval()
    np.testing.assert_allclose(_apply_torch(td, xs), want_d, rtol=RTOL, atol=ATOL)
    # and the fused graph computes what the branched one does
    np.testing.assert_allclose(_apply_torch(td, xs), want, rtol=1e-4, atol=1e-4)


def test_transpose_matches_flax():
    """The ConvTranspose kernel needs a spatial flip between the two
    frameworks; a missing flip scrambles every 2x2 output cell."""
    x = _inputs([(2, 5, 6, 8)], 2)
    fm = jb.Transpose(4)
    variables = init_flax(fm, x, seed=3)
    tm = load_state_dict_strict(tb.Transpose(8, 4), jax_to_state_dict(variables))
    np.testing.assert_allclose(_apply_torch(tm, x), _apply_flax(fm, variables, x),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_dfl,reg_max", [(False, 0), (True, 16)])
@pytest.mark.parametrize("deploy", [False, True])
def test_detect_head_decode_matches_flax(use_dfl, reg_max, deploy):
    """The 290-column eval decode, anchors H-then-W, fp32 sigmoid."""
    chans = (8, 16, 24)
    shapes = [(2, 8, 10, 8), (2, 4, 5, 16), (2, 2, 3, 24)]
    xs = _inputs(shapes, 4)
    fm = JDetect(num_layers=3, use_dfl=use_dfl, reg_max=reg_max)
    variables = init_flax(fm, [xs], seed=5)
    if deploy:
        variables = jax.tree_util.tree_map(np.asarray, fuse_variables(variables))
        fm = JDetect(num_layers=3, use_dfl=use_dfl, reg_max=reg_max, deploy=True)
    want = np.asarray(fm.apply(variables, [jnp.asarray(x) for x in xs]))
    tm = TDetect(chans, use_dfl=use_dfl, reg_max=reg_max, deploy=deploy)
    load_state_dict_strict(tm, jax_to_state_dict(variables)).eval()
    with torch.no_grad():
        got = tm([nchw(x) for x in xs]).numpy()
    assert got.shape == want.shape == (2, 80 + 20 + 6, 290)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_get_block_only_repvgg():
    """Once only 'repvgg' was ported and the rest refused; now each of the
    five training modes gives the counterpart of the JAX package's block."""
    want = {"repvgg": tb.RepVGGBlock, "hyper_search": tb.LinearAddBlock,
            "repopt": tb.RealVGGBlock, "conv_relu": tb.SimConvWrapper,
            "conv_silu": tb.ConvWrapper}
    for mode, cls in want.items():
        assert tb.get_block(mode) is cls and cls.__name__ == jb.get_block(mode).__name__
    with pytest.raises(KeyError):
        tb.get_block("no_such_mode")


def test_detect_refuses_train_mode():
    """The train mode of the head is ported (it returns HeadTrainOutput); in
    train mode it refuses a batch that leaves its BatchNorm one value per
    channel, which has no batch statistics."""
    from yololp_tpu_torch.models.effidehead import HeadTrainOutput

    tm = TDetect((8, 16, 24), use_dfl=False, reg_max=0).train()
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        tm([torch.zeros(1, 8, 4, 4), torch.zeros(1, 16, 2, 2), torch.zeros(1, 24, 1, 1)])
    out = tm([torch.rand(2, 8, 4, 4), torch.rand(2, 16, 2, 2), torch.rand(2, 24, 1, 1)])
    assert isinstance(out, HeadTrainOutput) and out.ads.shape == (2, 21, 6, 37)
    assert out.reg.shape == (2, 21, 4) and [f.shape[1] for f in out.feats] == [8, 16, 24]

