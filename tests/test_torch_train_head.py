"""Port parity: the model's train forward (`.train()`, the non-deploy graph)
against `Model.apply(train=True, mutable=["batch_stats"])`.

yololpn at 128 px, B = 2, every parameter and BN statistic randomized from a
seed. Compared: the HeadTrainOutput (feats are NCHW in the port, NHWC in
JAX; the sigmoided scores as (B, A, C) and (B, A, 6, nads), raw reg/cor),
and the BN running statistics that the train step leaves behind. Flax
updates the running variance with the biased batch variance and the port's
BatchNorm2d does too (torch's own update uses the unbiased one, which would
be n/(n-1) larger: 3.2% on the coarsest level's 2 x 4 x 4 = 32 values).

Tolerance, fp32: rtol 1e-3, with an absolute floor of 2e-4 on the scores
and 5e-3 on the raw reg/cor, the feats and the BN statistics. In training
mode BN normalizes by the batch's own variance, which on the coarse levels
(32 values a channel at 128 px, B = 2) amplifies the conv-order differences of
fp32 (the eval graph holds 1e-4, tests/test_torch_models.py); flax's
E[x^2] - E[x]^2 variance in place of torch's two-pass one moves nothing
beyond that.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_layers import nchw
from test_torch_models import jax_variables
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.layers import blocks
from yololp_tpu_torch.models.effidehead import HeadTrainOutput
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)

RTOL, ATOL_SCORE, ATOL = 1e-3, 2e-4, 5e-3


def train_step_stats(variables, x):
    """The port's train forward on NHWC `x`: (output, state dict after)."""
    model = load_state_dict_strict(Model(Config.named("yololpn")),
                                   jax_to_state_dict(variables)).train()
    return model(nchw(x)), model.state_dict()


def test_train_output_and_bn_stats_match_flax(monkeypatch):
    name, size = "yololpn", 128
    variables = jax_variables(name, seed=31)
    x = np.random.default_rng(6).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    jout, mutated = jax.jit(lambda v, xx: JModel(JConfig.named(name)).apply(
        v, xx, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))

    before = jax_to_state_dict(variables)
    out, got_sd = train_step_stats(variables, x)
    assert isinstance(out, HeadTrainOutput)
    a = sum((size // s) ** 2 for s in (8, 16, 32))
    assert out.pro.shape == (2, a, 31) and out.ads.shape == (2, a, 6, 37)
    assert out.reg.shape == (2, a, 4) and out.cor.shape == (2, a, 8)
    for f in ("pro", "alp", "ads", "reg", "cor"):
        got, want = getattr(out, f).detach().numpy(), np.asarray(getattr(jout, f))
        assert got.dtype == np.float32
        atol = ATOL if f in ("reg", "cor") else ATOL_SCORE
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=f)
    assert len(out.feats) == 3
    for g, w in zip(out.feats, jout.feats):
        np.testing.assert_allclose(g.detach().numpy().transpose(0, 2, 3, 1), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)

    # the running statistics after one train step
    want_sd = jax_to_state_dict({"params": variables["params"],
                                 "batch_stats": jax.device_get(mutated["batch_stats"])})
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    moved = 0
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        moved += not torch.equal(got_sd[k], before[k])
    assert moved == len(stats)

    # the batch variance each update took in, on the coarsest level
    # (running' = 0.97 running + 0.03 var): the port's is flax's; torch's own
    # BatchNorm2d update (the unbiased variance) is n/(n-1) = 32/31 of it
    k = "detect.stem2.bn.running_var"

    def batch_var(sd):
        return (sd[k].numpy() - 0.97 * before[k].numpy()) / 0.03

    monkeypatch.setattr(blocks.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward)
    torch_var = batch_var(train_step_stats(variables, x)[1])
    np.testing.assert_allclose(batch_var(got_sd), batch_var(want_sd), rtol=1e-3)
    np.testing.assert_allclose(torch_var / batch_var(got_sd), 32 / 31, rtol=1e-3)


def test_backward_of_the_train_output_reaches_every_parameter():
    model = Model(Config.named("yololpn")).train()
    out = model(torch.rand(2, 3, 64, 64))
    (out.pro.sum() + out.alp.sum() + out.ads.sum() + out.reg.sum() + out.cor.sum()).backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, missing[:5]
    model.eval()
    with torch.no_grad():
        assert model(torch.rand(1, 3, 64, 64)).shape == (1, 84, 290)
