"""Port parity: checkpoints written by the JAX `save_checkpoint` load in the
port without flax, in train and deploy format, and the converted weights
give the same outputs; checkpoints the port writes (its own msgpack encoder,
without the msgpack package) load in the JAX package as the same tree, its
`strip_checkpoint` agrees with JAX's, and a state dict survives the trip to
the flax tree and back exactly.

Tolerances: loaded trees must equal the JAX loader's bit for bit (msgpack
carries raw float32 bytes). A train-format checkpoint is fused by each
package's own fold, which agree to fp32 rounding (1e-6); the yololpn decode
at 64 px is then held to the same bounds as tests/test_torch_models.py.
"""

import sys

import numpy as np
import pytest
import torch
from flax import serialization

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
def trees():
    """Two randomized train-format yololpn trees (variables, EMA)."""
    return jax_variables("yololpn", seed=31), jax_variables("yololpn", seed=32)


@pytest.fixture(scope="module")
def saved(tmp_path_factory, trees):
    """Train- and deploy-format yololpn checkpoints; 'ema' differs from
    'variables' so that the loader's preference shows."""
    variables, ema = trees
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


def _trees_equal(a, b, path=()):
    """Bit-for-bit equality of two checkpoint trees (dtypes and shapes too)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _trees_equal(a[k], b[k], path + (k,))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.fixture(scope="module")
def port_train_ckpt(trees):
    """A train-format checkpoint tree as the port's Trainer writes it."""
    from yololp_tpu_torch.utils.convert import state_dict_to_jax

    sd, ema = (jax_to_state_dict(t) for t in trees)
    mom = {k: v * 0.5 for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}
    return {"format": "train", "step": 1234, "epoch": 5,
            "variables": state_dict_to_jax(sd), "ema": state_dict_to_jax(ema),
            "opt_state": {"momentum": state_dict_to_jax(mom)["params"],
                          "ema_updates": np.asarray(617, np.int32),
                          "last_opt_step": np.asarray(1232, np.int32)},
            "meta": {"cfg": "yololpn", "img_size": 64, "lr": 0.25, "note": None,
                     "flag": True, "scalar": np.float32(1.5), "k": -1_000_000}}


def test_port_written_checkpoint_loads_in_flax_as_the_same_tree(port_train_ckpt, tmp_path,
                                                                monkeypatch):
    """Written (and read back) with msgpack unimportable, as on the machine
    with the card; flax's loader reads the same tree bit for bit, and the
    file's bytes are flax's own encoding of it."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    path = str(tmp_path / "port.msgpack")
    tckpt.save_checkpoint(port_train_ckpt, path)
    own = tckpt.load_checkpoint_raw(path)
    monkeypatch.undo()
    _trees_equal(jckpt.load_checkpoint_raw(path), port_train_ckpt)
    _trees_equal(own, port_train_ckpt)
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(port_train_ckpt)
    # and the JAX package takes it for inference: EMA preferred, fused
    jvars = jckpt.load_inference_variables(path)
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jvars))
    got = tckpt.load_inference_variables(path)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def test_strip_checkpoint_agrees_with_flax(port_train_ckpt, tmp_path):
    src = str(tmp_path / "last.msgpack")
    tckpt.save_checkpoint(port_train_ckpt, src)
    tckpt.strip_checkpoint(src, str(tmp_path / "port_final.msgpack"))
    jckpt.strip_checkpoint(src, str(tmp_path / "jax_final.msgpack"))
    got = tckpt.load_checkpoint_raw(str(tmp_path / "port_final.msgpack"))
    _trees_equal(got, jckpt.load_checkpoint_raw(str(tmp_path / "jax_final.msgpack")))
    assert got["ema"] is None and got["opt_state"] is None
    _trees_equal(got["variables"], port_train_ckpt["ema"])
    tckpt.save_best_copy(src, str(tmp_path / "best.msgpack"))
    assert (tmp_path / "best.msgpack").read_bytes() == (tmp_path / "last.msgpack").read_bytes()


@pytest.mark.parametrize("graph", ["train", "deploy"])
def test_state_dict_flax_round_trip_is_exact(graph, trees):
    from yololp_tpu_torch.layers.fuse import fuse_state_dict
    from yololp_tpu_torch.utils.convert import state_dict_to_jax

    variables = trees[0]
    sd = jax_to_state_dict(variables)
    if graph == "deploy":
        sd = fuse_state_dict(sd)
        variables = {"params": jax.tree_util.tree_map(
            np.asarray, fuse_variables(variables)["params"])}
    tree = state_dict_to_jax(sd)
    back = jax_to_state_dict(tree)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    if graph == "train":  # the flax tree itself comes back leaf for leaf
        _trees_equal(tree, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables))
    else:
        model = load_state_dict_strict(Model(Config.named("yololpn"), deploy=True), back)
        assert set(model.state_dict()) == set(back)
