"""JAX variable trees <-> this package's state dicts.

The port's module tree carries the JAX package's module names (the naming
contract of layers/blocks.py), so a flax path maps to the same dotted torch
path. Only the leaves and layouts change:

  * conv 'kernel' HWIO -> 'weight' OIHW (transpose 3, 2, 0, 1)
  * ConvTranspose ('upsample_transpose') 'kernel' HWIO -> spatial flip ->
    'weight' (in, out, kH, kW): flax's conv_transpose does not flip its
    kernel, torch's (the conv adjoint) does (yololp_tpu/utils/transplant.py:9-11,71-72)
  * BatchNorm params 'scale'/'bias' -> 'weight'/'bias', batch_stats
    'mean'/'var' -> 'running_mean'/'running_var'
  * a ScaleLayer's 'weight' (modules 'scale_conv', 'scale_1x1',
    'scale_identity') and a BottleRep's 'alpha' keep their names

Input trees are nested dicts of numpy arrays, as a msgpack checkpoint holds
them, in train format ({'params', 'batch_stats'}) or deploy format
({'params'} only). `state_dict_to_jax` is the inverse: what the port writes
into a checkpoint loads in the JAX package as its own tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_TRANSPOSE_CONV = "upsample_transpose"
_PARAM_LEAVES = {"bias": "bias", "scale": "weight", "weight": "weight", "alpha": "alpha"}
# the ScaleLayer modules of a LinearAddBlock: their 1-d 'weight' is a
# ScaleLayer's, not a BatchNorm's 'scale'
_SCALE_LAYERS = {"scale_conv", "scale_1x1", "scale_identity"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_STAT_NAMES = {v: k for k, v in _STAT_LEAVES.items()}


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _weight(module: str, kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim != 4:
        raise ValueError(f"{module}: expected a 4-d HWIO kernel, got {kernel.shape}")
    if module.rsplit(".", 1)[-1] == _TRANSPOSE_CONV:
        return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    return np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))


def _key(path: Tuple[str, ...], leaf: str) -> str:
    """The state dict key of flax leaf `path` renamed to `leaf`."""
    return ".".join(path[:-1] + (leaf,))


def jax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert JAX variables (numpy leaves) to this package's state dict
    (CPU float32 tensors), without BN's num_batches_tracked buffers."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(variables["params"]):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            out[_key(path, "weight")] = _weight(module, arr)
        elif leaf in _PARAM_LEAVES:
            out[_key(path, _PARAM_LEAVES[leaf])] = arr
        else:
            raise KeyError(f"no mapping for param leaf {'.'.join(path)!r}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        if path[-1] not in _STAT_LEAVES:
            raise KeyError(f"no mapping for batch_stats leaf {'.'.join(path)!r}")
        out[_key(path, _STAT_LEAVES[path[-1]])] = arr
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _kernel(module: str, weight: np.ndarray) -> np.ndarray:
    if module.rsplit(".", 1)[-1] == _TRANSPOSE_CONV:
        return np.ascontiguousarray(weight.transpose(2, 3, 0, 1)[::-1, ::-1])
    return np.ascontiguousarray(weight.transpose(2, 3, 1, 0))


def _insert(tree: Dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def state_dict_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """A state dict of this package (train or deploy graph) -> the JAX
    package's {'params', 'batch_stats'} tree of float32 numpy arrays: OIHW
    -> HWIO, the transposed conv unflipped, BN 'weight' -> 'scale' (a
    ScaleLayer's 'weight' and a BottleRep's 'alpha' keep their names; a
    1-d 'weight' is told apart by its module's name) and the running
    statistics -> batch_stats 'mean'/'var'. BN's step counters are
    dropped; a tree without statistics has no 'batch_stats'."""
    params: Dict = {}
    stats: Dict = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        module = ".".join(mods)
        arr = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight" and arr.ndim == 4:
            _insert(params, mods + ["kernel"], _kernel(module, arr))
        elif leaf == "weight" and arr.ndim == 1:
            _insert(params, mods + ["weight" if mods[-1] in _SCALE_LAYERS else "scale"],
                    arr.copy())
        elif leaf in ("bias", "alpha"):
            _insert(params, mods + [leaf], arr.copy())
        elif leaf in _STAT_NAMES:
            _insert(stats, mods + [_STAT_NAMES[leaf]], arr.copy())
        else:
            raise KeyError(f"no mapping for state dict entry {key!r}")
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def load_state_dict_strict(model: nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Load `state_dict` into `model`, requiring every parameter and buffer
    except BN's step counters, which the JAX trees do not hold."""
    own = model.state_dict()
    full = {k: v for k, v in own.items() if k.endswith("num_batches_tracked")}
    full.update(state_dict)
    model.load_state_dict(full, strict=True)
    return model
