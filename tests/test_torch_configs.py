"""Every model config of the JAX package has its copy in the port, and the
port's module tree matches the flax variable tree key for key and shape
for shape, both ways through utils/convert.py.

The flax side is read by `jax.eval_shape` of `Model.init` and the port is
built on the `meta` device, so nothing is computed. Configs whose model
architecture is equal (the `*_finetune` and `*_qat` copies, among others)
share one trace (22 architectures among the 42 configs).
"""

import functools
import glob
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, state_dict_to_jax

_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _config_names(package):
    cfg_dir = osp.join(_ROOT, package, "configs")
    return sorted(osp.relpath(p, cfg_dir)[:-3].replace(osp.sep, "/")
                  for p in glob.glob(osp.join(cfg_dir, "**", "*.py"), recursive=True)
                  if not osp.basename(p).startswith("_"))


JAX_CONFIGS = _config_names("yololp_tpu")
MODEL_CONFIGS = [c for c in JAX_CONFIGS if "model" in JConfig.named(c)]


def test_every_config_file_is_copied():
    assert len(JAX_CONFIGS) == 43 and len(MODEL_CONFIGS) == 42
    assert _config_names("yololp_tpu_torch") == JAX_CONFIGS
    for name in JAX_CONFIGS:
        want = {k: v for k, v in JConfig.named(name).items() if k != "_filename"}
        got = {k: v for k, v in Config.named(name).items() if k != "_filename"}
        assert got == want, name


def _plain(x):
    """No DotDict anywhere inside x."""
    if isinstance(x, dict):
        return type(x) is dict and all(_plain(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_plain(v) for v in x)
    return True


def test_to_dict_equals_jax():
    """DotDict.to_dict on every config and on DotDicts inside lists and
    tuples: the JAX package's plain dicts."""
    from yololp_tpu.utils.config import DotDict as JDotDict
    from yololp_tpu_torch.utils.config import DotDict

    nested = {"a": [{"b": 1}, 2], "t": ({"c": {"d": [3]}},), "e": None}
    cases = [(DotDict(nested), JDotDict(nested))]
    cases += [(Config.named(n), JConfig.named(n)) for n in JAX_CONFIGS]
    for port, jax_cfg in cases:
        got, want = port.to_dict(), jax_cfg.to_dict()
        got.pop("_filename", None)  # each package's own config file
        want.pop("_filename", None)
        assert got == want and _plain(got)
    assert DotDict(nested).to_dict() == nested
    assert type(DotDict(nested).to_dict()["t"]) is tuple


@functools.lru_cache(maxsize=None)
def _flax_shapes(arch):
    """The flax train-graph tree's leaf shapes, one trace per architecture
    (the configs that differ only in data, solver or pretrained weights
    share it)."""
    cfg = _ARCH_NAMES[arch]
    size = 128 if cfg["model"]["head"]["num_layers"] == 4 else 64
    shapes = jax.eval_shape(lambda: JModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    return jax.tree_util.tree_map(lambda s: s.shape, shapes)


_ARCH_NAMES = {}


def _port_layout(path, shape):
    """The shape convert.py gives a flax leaf: HWIO kernels to OIHW, the
    transposed conv's to (in, out, kH, kW)."""
    if len(shape) != 4:
        return tuple(shape)
    h, w, i, o = shape
    return (i, o, h, w) if path[-2] == "upsample_transpose" else (o, i, h, w)


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_config_state_dict_matches_flax_tree(name):
    """Through convert.py both ways on stand-in leaves of one element (each
    holding its leaf's index, so a key's source leaf is known), then the
    full-size shapes: the flax leaf's, laid out as convert.py lays it out,
    equal the port's."""
    cfg = JConfig.named(name)
    m = cfg["model"]
    arch = repr((m["depth_multiple"], m["width_multiple"], m["backbone"], m["neck"],
                 m["head"]["num_layers"], m["head"]["reg_max"],
                 cfg.get("training_mode", "repvgg")))
    _ARCH_NAMES.setdefault(arch, cfg)
    shapes = _flax_shapes(arch)
    paths, treedef = jax.tree_util.tree_flatten_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    keys = [tuple(k.key for k in p) for p, _ in paths]
    stand_in = jax.tree_util.tree_unflatten(
        treedef, [np.full((1,) * len(s), i, np.float32) for i, (_, s) in enumerate(paths)])
    with torch.device("meta"):
        model = Model(Config.named(name))
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    # flax -> port: one port entry per flax leaf, of the port's full shape
    sd = jax_to_state_dict(stand_in)
    assert sd.keys() == own.keys(), sorted(set(sd) ^ set(own))[:6]
    for k, t in sd.items():
        i = int(t.reshape(-1)[0])
        assert own[k] == _port_layout(keys[i][1:], paths[i][1]), k
    # port -> flax: the tree the port writes is the flax tree
    back = state_dict_to_jax({k: torch.zeros((1,) * len(s)) for k, s in own.items()})
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(stand_in))
