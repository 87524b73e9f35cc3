"""Read the JAX package's msgpack checkpoints without flax (mirrors
yololp_tpu/utils/checkpoint.py:41-52).

A checkpoint is one msgpack file holding
  {'format': 'train'|'deploy', 'step': int, 'variables': {...},
   'ema': {...}|None, 'opt_state': {...}|None, 'meta': {...}}
with arrays in flax's msgpack extension types. Inference prefers 'ema' over
'variables' and folds a train-format tree to the deploy graph.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from yololp_tpu_torch.layers.fuse import fuse_state_dict
from yololp_tpu_torch.utils.convert import jax_to_state_dict

# flax.serialization._MsgpackExtType
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Undo flax's chunking of arrays larger than 1 GiB."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_checkpoint_raw(path: str) -> Dict[str, Any]:
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)
    return _unchunk(tree)


def load_inference_variables(path: str) -> Dict[str, torch.Tensor]:
    """Load a checkpoint for inference: prefer EMA, return the deploy
    graph's state dict (CPU float32 tensors)."""
    ckpt = load_checkpoint_raw(path)
    variables = ckpt.get("ema") or ckpt["variables"]
    state_dict = jax_to_state_dict(variables)
    if ckpt.get("format") == "deploy":
        return state_dict
    return fuse_state_dict(state_dict)
