"""Port parity: QAT's straight-through gradient (quant/quantize.py).

`fake_quant_ste`'s gradient equals `jax.grad` of the jitted `fake_quant`
(its custom VJP, `_fq_bwd`) exactly, for a constant amax (quantized_apply's
calibrated values) and for a traced per-channel one (quantize_weights'),
on values that include the clip edges.

A QAT loss on yololpn at 64 px, batch 2, and its gradients w.r.t. every
parameter: every conv kernel fake-quantized per output channel
(`quantize_weights(train=True)`, run through `torch.func.functional_call`)
and the network input fake-quantized at the stem (`quantized_apply(train=
True)`'s pre-hook), both through the straight-through estimator. Held
against the jitted JAX QAT loss run in float64 (`jax.enable_x64`; the
fake-quant computes in fp32 there too, as the JAX package casts to it), on
the same [0, 1] input: the quantized kernels and the stem's codes are then
equal bit for bit, and the rest is the fp32 train forward and backward. In
fp32 the jitted JAX backward of the train-mode backbone is numerically poor
(tests/test_torch_train_step.py; ROADMAP C).

Why not every conv input: a fake-quant is a step function, and the two
frameworks' convs sum in other orders (~1e-6 relative), which moves a few
values across a code's edge; in a deep random net in train mode each such
flip (1/127 of amax) spreads and flips more downstream. Measured at 64 px
with every conv input of the train graph quantized: loss 24.52 (port) and
22.74 (JAX fp32); with the deploy graph's calibrated set (as the trainer's
--quant uses it): 18.36 and 18.31 (128 px: 26.13 and 25.47). The code
paths are the same ones the stem input takes here.

Tolerances: the loss and its items within rtol 1e-3; each gradient tensor
within 1e-3 of its largest magnitude plus 1e-6 of the largest gradient of
any tensor (a bias feeding a train-mode BN through a linear map has a zero
gradient, and fp32 leaves rounding noise there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_train_step import fast_jax_variables, synthetic_batch
from yololp_tpu.losses import loss as jloss
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.quant import quantize as jq
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.losses.loss import LossConfig, compute_loss
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.ops.division import unit_pixels
from yololp_tpu_torch.quant import quantize as tq
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(4)

IMG = 64
SKIP = ("proj_conv",)
# LLVM at -O0 for the float64 reference: the same XLA program, compiled in
# a fraction of the time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def edge_values(rng, amax, shape):
    """Values around and at +-amax (and beyond), in fp32."""
    x = rng.uniform(-1.5, 1.5, shape).astype(np.float32) * amax
    flat = x.reshape(-1)
    flat[:4] = [amax, -amax, np.nextafter(amax, np.float32(2 * amax)), -np.nextafter(amax, 0)]
    return x


def test_ste_gradient_equals_jax_grad_constant_amax():
    rng = np.random.default_rng(0)
    amax = 0.7731
    x = edge_values(rng, np.float32(amax), (4, 8, 5, 5))
    g = rng.standard_normal(x.shape).astype(np.float32)
    want = jax.grad(jax.jit(lambda a: jnp.sum(jq.fake_quant(a, amax) * g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tq.fake_quant_ste(xt, amax)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(
        jax.jit(lambda a: jq.fake_quant(a, amax))(jnp.asarray(x))))
    assert (xt.grad.numpy() == 0).any() and (xt.grad.numpy() != 0).any()


def test_ste_gradient_equals_jax_grad_traced_amax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 3, 8, 6)).astype(np.float32)  # HWIO, 6 output channels
    amax = (np.abs(w).max(axis=(0, 1, 2)) * rng.uniform(0.5, 1.0, 6)).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)

    def f(v, a):
        return jnp.sum(jq.fake_quant(v, a) * g)

    want_x, want_a = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(amax))
    assert not np.asarray(want_a).any()  # no gradient to amax
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()  # OIHW
    at = torch.from_numpy(amax).reshape(6, 1, 1, 1).requires_grad_()
    y = tq.fake_quant_ste(wt, at)
    (y * torch.from_numpy(g.transpose(3, 2, 0, 1).copy())).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(want_x))
    assert at.grad is None
    np.testing.assert_array_equal(y.detach().numpy().transpose(2, 3, 1, 0), np.asarray(
        jax.jit(jq.fake_quant)(jnp.asarray(w), jnp.asarray(amax))))


@pytest.fixture(scope="module")
def qat_case():
    variables = fast_jax_variables("yololpn", seed=41)
    imgs, labels, mask = synthetic_batch(np.random.default_rng(9), img=IMG)
    model = load_state_dict_strict(Model(Config.named("yololpn")), jax_to_state_dict(variables))
    x = unit_pixels(torch.from_numpy(imgs).permute(0, 3, 1, 2), torch.float32).contiguous()
    # the stem's 3x3 and 1x1 branch convs take the network input
    amax = {"backbone/stem/rbr_dense_conv": 0.8125, "backbone/stem/rbr_1x1_conv": 0.8125}
    return variables, x, labels, mask, model, amax


def port_qat(model, x, labels, mask, amax):
    model.train()
    model.zero_grad(set_to_none=True)
    q = tq.quantize_weights(model, skip_substrings=SKIP, train=True)
    out = tq.quantized_apply(model, x, amax, skip_substrings=SKIP, train=True, weights=q)
    total, items = compute_loss(out, torch.from_numpy(labels), torch.from_numpy(mask),
                                LossConfig(img_size=(IMG, IMG), iou_type="siou"))
    total.backward()
    return float(total.detach()), items.numpy(), {n: p.grad.numpy()
                                                  for n, p in model.named_parameters()}


def jax_qat(variables, x_nchw, labels, mask, amax):
    with jax.enable_x64(True):
        dt = jnp.float64
        jm = JModel(JConfig.named("yololpn"), dtype=dt)
        lcfg = jloss.LossConfig(img_size=(IMG, IMG), iou_type="siou")
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), variables)

        def loss(params):
            q = jq.quantize_weights(params, skip_substrings=SKIP)
            x = jnp.asarray(x_nchw.numpy().transpose(0, 2, 3, 1)).astype(dt)
            out, _ = jq.quantized_apply(jm, {"params": q, "batch_stats": v["batch_stats"]}, x,
                                        amax, skip_substrings=SKIP, train=True,
                                        mutable=["batch_stats"])
            return jloss.compute_loss(out, jnp.asarray(labels), jnp.asarray(mask), lcfg)

        (total, items), grads = jax.jit(jax.value_and_grad(loss, has_aux=True),
                                        compiler_options=FAST_COMPILE)(v["params"])
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(grads))
        return float(total), np.asarray(items, np.float32), {
            k: t.numpy() for k, t in jax_to_state_dict({"params": grads}).items()}


def test_qat_loss_and_gradients_match_jax(qat_case):
    variables, x, labels, mask, model, amax = qat_case
    total, items, grads = port_qat(model, x, labels, mask, amax)
    jtotal, jitems, jgrads = jax_qat(variables, x, labels, mask, amax)
    assert np.isfinite(total)
    np.testing.assert_allclose(total, jtotal, rtol=1e-3)
    np.testing.assert_allclose(items, jitems, rtol=1e-3, atol=1e-7)
    assert set(grads) == set(jgrads)
    floor = 1e-6 * max(np.abs(g).max() for g in jgrads.values())
    worst = max((float(np.abs(grads[k] - g).max() / (1e-3 * np.abs(g).max() + floor)), k)
                for k, g in jgrads.items())
    assert worst[0] <= 1.0, worst
    # the fake-quant changed the loss: QAT is not the float forward
    model.train()
    with torch.no_grad():
        plain, _ = compute_loss(model(x), torch.from_numpy(labels), torch.from_numpy(mask),
                                LossConfig(img_size=(IMG, IMG), iou_type="siou"))
    assert float(plain) != total
