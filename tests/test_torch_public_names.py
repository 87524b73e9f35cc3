"""The last public names of the JAX package that the port lacked, against
their JAX counterparts: layers/blocks.py:torch_pad and SiluConv,
layers/fuse.py:fuse_variables, solver/build.py:param_group_label and
label_tree, and ops/nms.py:greedy_nms_mask (a re-export of the kernel's
wrapper). tests/test_torch_api_parity.py keeps the list complete."""

import glob
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_layers import randomize_variables
from test_torch_zoo import narrow
from yololp_tpu.layers import blocks as jblocks
from yololp_tpu.layers.fuse import fuse_variables as jfuse_variables
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.solver.build import label_tree as jlabel_tree
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.layers import blocks
from yololp_tpu_torch.layers.fuse import fuse_model, fuse_variables
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.ops import cuda_nms, nms
from yololp_tpu_torch.solver import build
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import (jax_to_state_dict, load_state_dict_strict,
                                            state_dict_to_jax)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_torch_pad_equals_jax(k):
    assert blocks.torch_pad(k) == jblocks.torch_pad(k)
    assert blocks.ConvBNAct(4, 4, k).conv.padding == tuple(p for p, _ in blocks.torch_pad(k))


def test_silu_conv_is_a_silu_conv_bn_act():
    m = blocks.SiluConv(4, 8, 3, 2)
    assert isinstance(m, blocks.ConvBNAct) and isinstance(m.act, torch.nn.SiLU)
    assert m.conv.stride == (2, 2)


def test_greedy_nms_mask_is_the_kernel_wrapper():
    assert nms.greedy_nms_mask is cuda_nms.greedy_nms_mask


@pytest.mark.parametrize("name", ["yololpn", "repopt/yolov6n_hs"])
def test_fuse_variables_equals_jax(name):
    model = Model(narrow(Config.named(name)))
    variables = randomize_variables(state_dict_to_jax(model.state_dict()), 3)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jfuse_variables)(variables))
    got = fuse_variables(variables)
    assert set(got) == {"params"}
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for k, v in flat_w.items():
        np.testing.assert_allclose(flat_g[k], v, rtol=1e-6, atol=1e-6, err_msg=str(k))
    # and it is the port's own fusion of the same weights
    model = load_state_dict_strict(model, jax_to_state_dict(variables))
    for k, v in jax_to_state_dict(got).items():
        assert torch.equal(fuse_model(model).state_dict()[k], v), k


# every way a parameter is named: the RepVGG branches, the CSP BottleReps'
# alphas, the hyper-search ScaleLayers, the conv_silu ConvWrappers and the
# 4-level head
@pytest.mark.parametrize("name", ["yololpn", "yolov6m", "repopt/yolov6n_hs", "yolov6l",
                                  "yolov6n6"])
def test_label_tree_equals_jax(name):
    jcfg = narrow(JConfig.named(name))
    size = 128 if jcfg["model"]["head"]["num_layers"] == 4 else 64
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))["params"]
    codes = {"w": 0, "bnw": 1, "bias": 2}
    labels = jlabel_tree(shapes)
    coded = jax.tree_util.tree_map(lambda lab, s: np.full(s.shape, codes[lab], np.float32),
                                   labels, shapes)
    want = {k: int(v.reshape(-1)[0]) for k, v in jax_to_state_dict({"params": coded}).items()}
    model = Model(narrow(Config.named(name)))
    got = build.label_tree(dict(model.named_parameters()))
    assert got.keys() == want.keys()
    assert {k: codes[v] for k, v in got.items()} == want
    assert got == build.label_groups(model)
    assert build.param_group_label("backbone.stem.rbr_identity_bn.weight") == "bnw"
    assert build.param_group_label("neck.Rep_p4.conv1.scale_conv.weight") == "w"


_CFG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "yololp_tpu_torch", "configs")
PORT_MODEL_CONFIGS = [c for c in sorted(
    osp.relpath(p, _CFG_DIR)[:-3].replace(osp.sep, "/")
    for p in glob.glob(osp.join(_CFG_DIR, "**", "*.py"), recursive=True)
    if not osp.basename(p).startswith("_")) if "model" in Config.named(c)]


@pytest.mark.parametrize("name", PORT_MODEL_CONFIGS)
def test_label_groups_find_every_batch_norm_weight(name):
    """`param_group_label` finds BN weights by module name (`*bn`): on every
    model config, at full size on the meta device, its labels are those of
    the module types (a BN weight is 'bnw', any other weight 'w')."""
    with torch.device("meta"):
        model = Model(Config.named(name))
    modules = dict(model.named_modules())
    want = {}
    for key, _ in model.named_parameters():
        module, _, leaf = key.rpartition(".")
        is_bn = isinstance(modules[module], torch.nn.modules.batchnorm._BatchNorm)
        want[key] = "bias" if leaf == "bias" else "bnw" if is_bn and leaf == "weight" else "w"
    assert build.label_groups(model) == want
