"""Port parity: the whole yololpn / yololps forward against `Model.apply`.

Every parameter and BN statistic is randomized from a seeded numpy generator
(the head's zero-initialised pred kernels would otherwise make every score
the same constant) and carried into the port. Both graphs are compared: the
train graph (3-branch RepVGG blocks, BN with running statistics) and the
deploy graph after each package's own fusion.

Tolerance, fp32 on the CPU: the two frameworks sum conv products in different
orders, and the ~70 convs compound that to a few 1e-6 relative. The 290-column
decode is held to rtol 1e-4 with an absolute floor of 1e-3 px on boxes and
corners (up to ~10^3 px) and 1e-5 on scores (in [0, 1]).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_layers import nchw, randomize_variables
from yololp_tpu.layers.fuse import fuse_variables
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.models.yolo import build_model as jbuild_model
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.layers.fuse import fuse_model, fuse_state_dict
from yololp_tpu_torch.models.yolo import Model, build_model, scaled_lists
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)

RTOL = 1e-4
ATOL_PX = 1e-3
ATOL_SCORE = 1e-5


def assert_decode_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=RTOL, atol=ATOL_PX)
    np.testing.assert_allclose(got[..., 13:], want[..., 13:], rtol=RTOL, atol=ATOL_SCORE)


def jax_variables(name, seed):
    """Randomized train-format JAX variables of a named config."""
    _, variables = jbuild_model(JConfig.named(name), img_size=(64, 64))
    return randomize_variables(jax.tree_util.tree_map(np.asarray, variables), seed)


@pytest.mark.parametrize("name,size,batch", [("yololpn", 96, 2), ("yololps", 64, 1)])
def test_model_matches_flax_in_train_and_deploy_graphs(name, size, batch):
    cfg = Config.named(name)
    variables = jax_variables(name, seed=sum(map(ord, name)))
    x = np.random.default_rng(5).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    a = sum((size // s) ** 2 for s in (8, 16, 32))

    want = np.asarray(JModel(JConfig.named(name)).apply(variables, jnp.asarray(x), train=False))
    model = load_state_dict_strict(Model(cfg), jax_to_state_dict(variables)).eval()
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    assert got.shape == (batch, a, 290)
    assert_decode_close(got, want)

    fused = jax.tree_util.tree_map(np.asarray, fuse_variables(variables))
    want_d = np.asarray(JModel(JConfig.named(name), deploy=True).apply(fused, jnp.asarray(x)))
    deploy = fuse_model(model)
    assert deploy.deploy and not deploy.training
    with torch.no_grad():
        got_d = deploy(nchw(x)).numpy()
    assert_decode_close(got_d, want_d)
    # the port's fused graph also loads the JAX package's fused weights
    for k, v in jax_to_state_dict(fused).items():
        np.testing.assert_allclose(deploy.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_scaled_lists_and_state_dict_keys_match_flax():
    """Depth/width scaling and the module tree: every JAX leaf has exactly
    one port parameter or buffer, in train and deploy graphs."""
    from yololp_tpu.models.yolo import scaled_lists as jscaled

    for name in ("yololpn", "yololps"):
        assert scaled_lists(Config.named(name)) == jscaled(JConfig.named(name))
        _, variables = jbuild_model(JConfig.named(name), img_size=(64, 64))
        variables = jax.tree_util.tree_map(np.asarray, variables)
        train = Model(Config.named(name))
        own = {k for k in train.state_dict() if not k.endswith("num_batches_tracked")}
        assert own == set(jax_to_state_dict(variables))
        deploy = Model(Config.named(name), deploy=True)
        assert set(deploy.state_dict()) == set(
            jax_to_state_dict(jax.tree_util.tree_map(np.asarray, fuse_variables(variables))))
        assert set(fuse_state_dict(train.state_dict())) == set(deploy.state_dict())


def test_build_model_seeded_and_refuses_missing_gpu(monkeypatch):
    cfg = Config.named("yololpn")
    a = build_model(cfg, seed=3, device="cpu").state_dict()
    b = build_model(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
