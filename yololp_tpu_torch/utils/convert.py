"""JAX variable trees -> this package's state dicts.

The port's module tree carries the JAX package's module names (the naming
contract of layers/blocks.py), so a flax path maps to the same dotted torch
path. Only the leaves and layouts change:

  * conv 'kernel' HWIO -> 'weight' OIHW (transpose 3, 2, 0, 1)
  * ConvTranspose ('upsample_transpose') 'kernel' HWIO -> spatial flip ->
    'weight' (in, out, kH, kW): flax's conv_transpose does not flip its
    kernel, torch's (the conv adjoint) does (yololp_tpu/utils/transplant.py:9-11,71-72)
  * BatchNorm params 'scale'/'bias' -> 'weight'/'bias', batch_stats
    'mean'/'var' -> 'running_mean'/'running_var'

Input trees are nested dicts of numpy arrays, as a msgpack checkpoint holds
them, in train format ({'params', 'batch_stats'}) or deploy format
({'params'} only).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_TRANSPOSE_CONV = "upsample_transpose"
_PARAM_LEAVES = {"bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


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


def jax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert JAX variables (numpy leaves) to this package's state dict
    (CPU float32 tensors), without BN's num_batches_tracked buffers."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(variables["params"]):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            out[module + ".weight"] = _weight(module, arr)
        elif leaf in _PARAM_LEAVES:
            out[module + "." + _PARAM_LEAVES[leaf]] = arr
        else:
            raise KeyError(f"no mapping for param leaf {'.'.join(path)!r}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"no mapping for batch_stats leaf {'.'.join(path)!r}")
        out[module + "." + _STAT_LEAVES[leaf]] = arr
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_state_dict_strict(model: nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Load `state_dict` into `model`, requiring every parameter and buffer
    except BN's step counters, which the JAX trees do not hold."""
    own = model.state_dict()
    full = {k: v for k, v in own.items() if k.endswith("num_batches_tracked")}
    full.update(state_dict)
    model.load_state_dict(full, strict=True)
    return model
