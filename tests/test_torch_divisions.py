"""Port parity for divisions by a constant: the port against `jax.jit` of the
JAX functions, bit for bit.

Inside jit XLA computes `x / c` for a trace-time constant `c` as
`x * fp32(1 / c)`; a traced divisor stays a true division. The port follows
what the JAX package runs (yololp_tpu_torch/ops/division.py), so every
comparison here has tolerance 0, and each case also checks that true
division would have failed it (the inputs discriminate).
"""

from typing import Any

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.quant import quantize as jq
from yololp_tpu_torch.ops.division import div_const, reciprocal, unit_pixels
from yololp_tpu_torch.quant import quantize as tq

PIXELS = np.arange(256, dtype=np.uint8)


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_all_256_pixel_values_equal_jit(jdt, tdt):
    want = jax.jit(lambda u: u.astype(jdt) / jnp.asarray(255.0, jdt))(jnp.asarray(PIXELS))
    got = unit_pixels(torch.from_numpy(PIXELS), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(bits(got.float()), bits(np.asarray(want, np.float32)))
    # the calibrator's image path is the same program
    img = torch.from_numpy(PIXELS.reshape(1, 16, 16, 1).repeat(3, -1))
    got_c = tq._image_tensor(img, "cpu", tdt)[0, 0].reshape(-1)
    np.testing.assert_array_equal(bits(got_c.float()), bits(np.asarray(want, np.float32)))
    if tdt == torch.float32:  # true division is off on 126 of the 256 values
        off = (torch.from_numpy(PIXELS).float() / 255.0).numpy() != np.asarray(want)
        assert off.sum() == 126


def test_div_const_is_the_fp32_reciprocal_multiply():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 7
    for c in (255.0, 127.0, 6.0, 27.0, 0.0017):
        want = jax.jit(lambda v: v / c)(jnp.asarray(x))
        np.testing.assert_array_equal(bits(div_const(torch.from_numpy(x), c)), bits(want))
        assert reciprocal(c) == float(np.float32(1) / np.float32(c))


# amax values where fp32(amax) / 127 != fp32(amax) * fp32(1 / 127)
AMAX = (2.425558567047119, 0.9269248843193054, 4.987917900085449)


@pytest.mark.parametrize("amax", AMAX)
def test_fake_quant_equals_jit_constant_and_traced_amax(amax):
    x = (np.random.default_rng(1).standard_normal(50000) * 3).astype(np.float32)
    xt = torch.from_numpy(x)
    # a constant amax (quantized_apply's calibrated values): scale folded by
    # true division, x / scale a reciprocal multiply
    want_c = jax.jit(lambda v: jq.fake_quant(v, jnp.asarray(amax, jnp.float32)))(jnp.asarray(x))
    np.testing.assert_array_equal(bits(tq.fake_quant(xt, amax)), bits(want_c))
    # a traced amax (quantize_weights under jit): amax * fp32(1/127), then a
    # true division
    want_t = jax.jit(jq.fake_quant)(jnp.asarray(x), jnp.float32(amax))
    np.testing.assert_array_equal(bits(tq.fake_quant(xt, torch.tensor(amax))), bits(want_t))
    assert (bits(want_c) != bits(want_t)).any()  # the two programs differ


def test_quantize_weights_equals_jit():
    w = (np.random.default_rng(2).standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32)
    want = jax.jit(jq.quantize_weights)({"c": {"kernel": jnp.asarray(w)}})["c"]["kernel"]
    eager = jq.quantize_weights({"c": {"kernel": jnp.asarray(w)}})["c"]["kernel"]
    conv = torch.nn.Conv2d(16, 32, 3, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    got = tq.quantize_weights(torch.nn.Sequential(conv))[0].weight.detach().numpy()
    np.testing.assert_array_equal(bits(got.transpose(2, 3, 1, 0)), bits(want))
    assert (bits(want) != bits(eager)).any()


class _JOneConv(fnn.Module):
    dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Conv(4, (1, 1), name="conv")(x)


class _TOneConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 1)

    def forward(self, x):
        return self.conv(x)


# widths of (1/255) / m: every pixel value k/255 lands within an ulp of the
# bin edge k * m, where true division and the reciprocal multiply part ways
@pytest.mark.parametrize("m", [1, 7, 13])
def test_histogram_bins_equal_jit_at_tolerance_0(m):
    amax = {"conv": tq.HIST_BINS / (255.0 * m)}
    imgs = np.random.default_rng(m).integers(0, 256, (2, 16, 16, 3), np.uint8)
    imgs[0, 0, :, 0] = np.arange(16) * 17  # spread over 0..255
    jm = _JOneConv()
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    want = np.asarray(jq.make_calib_fn(jm, jv, mode="histogram", skip_substrings=(),
                                       amax_by_path=amax)(jnp.asarray(imgs))["conv"])
    got = tq.make_calib_fn(_TOneConv(), mode="histogram", skip_substrings=(),
                           amax_by_path=amax)(imgs)["conv"]
    np.testing.assert_array_equal(got, want)
    width = amax["conv"] / tq.HIST_BINS
    a = torch.from_numpy(imgs).float() / 255.0  # true division of the pixels and the bins
    true_div = torch.bincount(torch.clamp((a / width).to(torch.int32), 0, tq.HIST_BINS - 1)
                              .reshape(-1).long(), minlength=tq.HIST_BINS).numpy()
    assert (true_div != want).any()
