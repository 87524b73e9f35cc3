"""Port parity: checkpoints written by the JAX `save_checkpoint` load in the
port without flax, in train and deploy format, and the converted weights
give the same outputs.

Tolerances: loaded trees must equal the JAX loader's bit for bit (msgpack
carries raw float32 bytes). A train-format checkpoint is fused by each
package's own fold, which agree to fp32 rounding (1e-6); the yololpn decode
at 64 px is then held to the same bounds as tests/test_torch_models.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_layers import nchw
from test_torch_models import assert_decode_close, jax_variables
from yololp_tpu.layers.fuse import fuse_variables
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.utils import checkpoint as jckpt
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.utils import checkpoint as tckpt
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Train- and deploy-format yololpn checkpoints; 'ema' differs from
    'variables' so that the loader's preference shows."""
    variables = jax_variables("yololpn", seed=31)
    ema = jax_variables("yololpn", seed=32)
    d = tmp_path_factory.mktemp("ckpt")
    paths = {"train": str(d / "train.msgpack"), "deploy": str(d / "deploy.msgpack")}
    jckpt.save_checkpoint({"format": "train", "step": 7, "variables": variables,
                           "ema": ema, "opt_state": None, "meta": {"epoch": 1}},
                          paths["train"])
    fused = jax.tree_util.tree_map(np.asarray, fuse_variables(ema))
    jckpt.save_checkpoint({"format": "deploy", "step": 7, "variables": fused,
                           "ema": None, "opt_state": None, "meta": {}}, paths["deploy"])
    return paths


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("fmt", ["train", "deploy"])
def test_raw_tree_equals_flax_loader(saved, fmt):
    want = dict(_leaves(jckpt.load_checkpoint_raw(saved[fmt])))
    got = dict(_leaves(tckpt.load_checkpoint_raw(saved[fmt])))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("fmt", ["train", "deploy"])
def test_inference_variables_give_flax_outputs(saved, fmt):
    jvars = jax.tree_util.tree_map(np.asarray, jckpt.load_inference_variables(saved[fmt]))
    sd = tckpt.load_inference_variables(saved[fmt])
    want_sd = jax_to_state_dict(jvars)
    assert set(sd) == set(want_sd)
    for k in want_sd:  # EMA was chosen and fused as the JAX loader does
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)

    x = np.random.default_rng(8).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JModel(JConfig.named("yololpn"), deploy=True).apply(jvars, jnp.asarray(x)))
    model = load_state_dict_strict(Model(Config.named("yololpn"), deploy=True), sd).eval()
    with torch.no_grad():
        assert_decode_close(model(nchw(x)).numpy(), want)


def test_strict_load_rejects_a_foreign_tree(saved):
    sd = tckpt.load_inference_variables(saved["deploy"])
    with pytest.raises(RuntimeError):  # deploy weights do not fit the train graph
        load_state_dict_strict(Model(Config.named("yololpn")), sd)
