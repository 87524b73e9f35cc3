"""Checkpoint I/O in the JAX package's msgpack format, without flax or the
msgpack package (mirrors yololp_tpu/utils/checkpoint.py).

A checkpoint is one msgpack file holding
  {'format': 'train'|'deploy', 'step': int, 'variables': {...},
   'ema': {...}|None, 'opt_state': {...}|None, 'meta': {...}}
with arrays in flax's msgpack extension types (ext 1: an ndarray as the
msgpack triple (shape, dtype name, raw bytes); ext 3: a numpy scalar, the
same triple of a 0-d array). Trees are the JAX package's (utils/convert.py
maps them to and from state dicts). Inference prefers 'ema' over
'variables' and folds a train-format tree to the deploy graph.

The machine with the card has no `msgpack` package, so this module encodes
and decodes the subset flax writes itself: maps, str, int, float, bool,
nil, bin, arrays, and the extension types 1 and 3 (2, a complex, is read
too). What `save_checkpoint` writes, flax's `msgpack_restore` reads as the
same tree, and `load_checkpoint_raw` reads what flax writes.
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from yololp_tpu_torch.layers.fuse import fuse_state_dict
from yololp_tpu_torch.utils.convert import jax_to_state_dict

# flax.serialization._MsgpackExtType
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# flax chunks arrays above this many bytes; no array of these models comes near
_MAX_CHUNK_SIZE = 2 ** 30


def _pack_len(n: int, small: Optional[int], fix_limit: int, codes) -> bytes:
    """A msgpack length header: fix form below fix_limit, else the 8/16/32-bit
    forms in `codes` (None where the type has no such form)."""
    if small is not None and n < fix_limit:
        return bytes([small | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    head = (bytes([fixed[len(data)]]) if len(data) in fixed
            else _pack_len(len(data), None, 0, (0xc7, 0xc8, 0xc9)))
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: the msgpack triple (shape, dtype name, raw
    C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > _MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes needs flax's chunking")
    return _packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, torch.Tensor):
        _pack(obj.detach().cpu().numpy(), out)
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj))))
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_pack_len(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb)) + data)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_len(len(obj), None, 0, (0xc4, 0xc5, 0xc6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 16, (None, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        # keys sorted, as flax's tree_map leaves them: the same bytes as flax writes
        out.append(_pack_len(len(obj), 0x80, 16, (None, 0xde, 0xdf)))
        for k, v in sorted(obj.items(), key=lambda kv: str(kv[0])):
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
          0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I",
        0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(buf: memoryview, pos: int):
    """One msgpack object at `pos` -> (object, next position): the subset
    flax writes, str as text, bin as bytes, arrays as lists."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x9f or 0xdc <= b <= 0xdf:
        if b <= 0x9f:
            n = b & 0x0f
        else:
            fmt = _LEN[b]
            n = struct.unpack_from(fmt, buf, pos)[0]
            pos += struct.calcsize(fmt)
        if b in (0xdc, 0xdd) or 0x90 <= b <= 0x9f:
            out = []
            for _ in range(n):
                v, pos = _unpack(buf, pos)
                out.append(v)
            return out, pos
        d = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            d[k], pos = _unpack(buf, pos)
        return d, pos
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in _LEN or b in _FIXEXT:
        if b in _FIXEXT:
            n = _FIXEXT[b]
        else:
            fmt = _LEN[b]
            n = struct.unpack_from(fmt, buf, pos)[0]
            pos += struct.calcsize(fmt)
        if b in _FIXEXT or b in (0xc7, 0xc8, 0xc9):
            code = struct.unpack_from(">b", buf, pos)[0]
            return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
        data = buf[pos:pos + n]
        return (bytes(data).decode("utf-8") if b >= 0xd9 else bytes(data)), pos + n
    raise ValueError(f"msgpack type byte 0x{b:02x} at {pos - 1} is not supported")


def _ndarray_from_bytes(data: memoryview) -> np.ndarray:
    (shape, dtype_name, buffer), _ = _unpack(data, 0)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, data: memoryview):
    """flax's extension types: ndarray, complex and numpy scalar."""
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        (re, im), _ = _unpack(data, 0)
        return complex(re, im)
    raise ValueError(f"unknown msgpack extension type {code}")


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
    """The checkpoint's tree as flax's msgpack_restore gives it."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    tree, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{path}: {len(buf) - end} bytes after the checkpoint")
    return _unchunk(tree)


def save_checkpoint(ckpt: Dict[str, Any], path: str):
    """Write `ckpt` (nested dicts of numpy arrays, tensors and Python
    scalars) as flax's msgpack, through a temporary file and a rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = _packb(ckpt)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def load_inference_variables(path: str) -> Dict[str, torch.Tensor]:
    """Load a checkpoint for inference: prefer EMA, return the deploy
    graph's state dict (CPU float32 tensors)."""
    ckpt = load_checkpoint_raw(path)
    variables = ckpt.get("ema") or ckpt["variables"]
    state_dict = jax_to_state_dict(variables)
    if ckpt.get("format") == "deploy":
        return state_dict
    return fuse_state_dict(state_dict)


def save_best_copy(last_path: str, best_path: str):
    """The reference's best_ckpt copy policy: a byte copy of the last one."""
    shutil.copyfile(last_path, best_path)


def strip_checkpoint(path: str, out_path: Optional[str] = None):
    """End-of-training strip: the EMA replaces the model, the optimizer
    state is dropped (written to `out_path`, or in place)."""
    ckpt = load_checkpoint_raw(path)
    if ckpt.get("ema"):
        ckpt["variables"] = ckpt["ema"]
    ckpt["ema"] = None
    ckpt["opt_state"] = None
    save_checkpoint(ckpt, out_path or path)
