"""RepOpt (RepVGG over the optimizer): the hyper-search scales, the
re-initialization of the RealVGG net and its gradient masks (mirrors
yololp_tpu/solver/repopt.py, the reference's yolov6/utils/RepOptimizer.py).

Two stages:
  1. hyper-search: train the CSLA net (LinearAddBlock, training_mode
     'hyper_search'); its per-branch scale vectors are the result.
  2. repopt: train the plain net (RealVGGBlock, training_mode 'repopt')
     whose 3x3 kernels are re-initialized as the scale-weighted sum of a
     fresh 3x3 and 1x1 (+ identity), and trained with per-weight gradient
     masks: scale_conv^2 everywhere, + scale_1x1^2 at the 3x3 centre, + 1 on
     the centre's diagonal when the identity branch exists.

Blocks are found by the naming contract: a LinearAddBlock is a node holding
{conv, conv_1x1, scale_conv, scale_1x1 [, scale_identity], bn}, a
RealVGGBlock a node whose child 'cell' holds a 'conv'. The CSLA net's scales
pair with the RealVGG net's blocks by position in flax's tree order: every
level's keys sorted as strings, as the JAX package walks them. (The order in
which torch registers modules is another order; pairing by it would load a
JAX-written scales file into the wrong blocks, silently where shapes agree.)
Kernels here are OIHW; a scale vector runs over the output channels.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yololp_tpu_torch.layers.fuse import _nest

_CSLA_KEYS = {"conv", "conv_1x1", "scale_conv", "scale_1x1", "bn"}

Scales = List[Tuple[np.ndarray, ...]]


def _walk(tree, path=()):
    """(path, 'csla' | 'realvgg', node) of every block, in flax's order."""
    if not isinstance(tree, dict):
        return
    keys = set(tree)
    if _CSLA_KEYS <= keys:
        yield path, "csla", tree
        return
    if "cell" in keys and isinstance(tree["cell"], dict) and "conv" in tree["cell"]:
        yield path, "realvgg", tree
        return
    for k in sorted(keys):
        yield from _walk(tree[k], path + (k,))


def _tree(params) -> Dict:
    """A nested tree of a flat state dict (dotted keys); a nested tree (a
    flax params tree, or a nested state dict) as it is."""
    if any(isinstance(v, dict) for v in params.values()):
        return params
    return _nest(dict(params))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def extract_scales(csla_params) -> Scales:
    """The scale tuples of a trained hyper-search net, in tree order: a
    triple (identity, 1x1, conv) where the block has an identity branch,
    else a pair (1x1, conv). `csla_params`: the port's state dict, or the
    flax params tree of a checkpoint (the ScaleLayer leaf is 'weight' in
    both)."""
    scales = []
    for _, kind, node in _walk(_tree(csla_params)):
        if kind != "csla":
            continue
        names = (["scale_identity"] if "scale_identity" in node else []) + ["scale_1x1",
                                                                            "scale_conv"]
        scales.append(tuple(_np(node[n]["weight"]).astype(np.float32) for n in names))
    return scales


def realvgg_conv_keys(state_dict: Mapping[str, torch.Tensor]) -> List[str]:
    """The state dict keys of the RealVGG 3x3 kernels, in tree order."""
    return [".".join(path + ("cell", "conv", "weight"))
            for path, kind, _ in _walk(_tree(state_dict)) if kind == "realvgg"]


def _check(keys, scales):
    if len(keys) != len(scales):
        raise ValueError(f"{len(keys)} RealVGG blocks vs {len(scales)} scale entries")


def reinitialize(state_dict: Mapping[str, torch.Tensor], scales: Scales,
                 generator: Optional[torch.Generator] = None,
                 kernels_1x1: Optional[Sequence[torch.Tensor]] = None,
                 use_identity_scales: bool = True) -> Dict[str, torch.Tensor]:
    """The RealVGG 3x3 kernels re-initialized as the CSLA-equivalent sum,
    {key: new kernel} for each one (the other entries are unchanged). The
    fresh 1x1 kernels, one per block in tree order, are `kernels_1x1`
    (OIHW) or drawn from `generator` as torch's Conv2d default init,
    U(-b, b) with b = 1/sqrt(fan_in). A block with an identity branch adds
    the identity times its identity scale, or, with use_identity_scales
    False, the plain identity."""
    keys = realvgg_conv_keys(state_dict)
    _check(keys, scales)
    out = {}
    for i, (key, sc) in enumerate(zip(keys, scales)):
        k3 = state_dict[key].detach().float()
        out_ch, in_ch = k3.shape[:2]
        if kernels_1x1 is not None:
            k1 = torch.as_tensor(kernels_1x1[i], dtype=torch.float32, device=k3.device)
        else:
            bound = 1.0 / np.sqrt(in_ch)
            k1 = torch.empty(out_ch, in_ch, 1, 1).uniform_(-bound, bound, generator=generator)
            k1 = k1.to(k3.device)
        col = [torch.as_tensor(s, dtype=torch.float32, device=k3.device).reshape(-1, 1, 1, 1)
               for s in sc]
        new = k3 * col[-1] + F.pad(k1, (1, 1, 1, 1)) * col[-2]
        if len(sc) == 3:
            if in_ch != out_ch:
                raise ValueError(f"{key}: an identity scale on a {in_ch}->{out_ch} kernel")
            eye = torch.zeros_like(new)
            eye[torch.arange(in_ch), torch.arange(in_ch), 1, 1] = 1.0
            new = new + (eye * col[0] if use_identity_scales else eye)
        out[key] = new.to(state_dict[key].dtype)
    return out


def gradient_masks(state_dict: Mapping[str, torch.Tensor],
                   scales: Optional[Scales]) -> Dict[str, torch.Tensor]:
    """{key: mask} for the RealVGG 3x3 kernels (every other parameter's mask
    is one): scale_conv^2 everywhere, + scale_1x1^2 at the centre, + 1 on the
    centre's diagonal for a block with an identity branch."""
    if scales is None:
        return {}
    keys = realvgg_conv_keys(state_dict)
    _check(keys, scales)
    masks = {}
    for key, sc in zip(keys, scales):
        k = state_dict[key]
        out_ch, in_ch = k.shape[:2]
        s_conv = torch.as_tensor(sc[-1], dtype=torch.float32, device=k.device)
        s_1x1 = torch.as_tensor(sc[-2], dtype=torch.float32, device=k.device)
        mask = torch.ones(k.shape, dtype=torch.float32, device=k.device) * (
            s_conv ** 2).reshape(-1, 1, 1, 1)
        mask[:, :, 1, 1] += torch.ones(out_ch, in_ch, device=k.device) * (s_1x1 ** 2).reshape(-1, 1)
        if len(sc) == 3:
            if in_ch != out_ch:
                raise ValueError(f"{key}: an identity scale on a {in_ch}->{out_ch} kernel")
            idx = torch.arange(in_ch, device=k.device)
            mask[idx, idx, 1, 1] += 1.0
        masks[key] = mask
    return masks


def save_scales(scales: Scales, path: str):
    """Write the scales as the JAX package does: {'scales': [[arrays]]} in
    flax's msgpack bytes."""
    from yololp_tpu_torch.utils.checkpoint import save_checkpoint

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_checkpoint({"scales": [[np.asarray(s, np.float32) for s in tup] for tup in scales]},
                    path)


def load_scales(path: str) -> Scales:
    """The scales of a save_scales() file, of either package, or extracted
    from a hyper-search training checkpoint's CSLA params ('ema', else
    'variables')."""
    from yololp_tpu_torch.utils.checkpoint import load_checkpoint_raw

    if not os.path.isfile(path):
        raise FileNotFoundError(f"RepOpt scales file not found: {path}")
    payload = load_checkpoint_raw(path)
    if "scales" in payload:
        return [tuple(np.asarray(s) for s in (tup.values() if isinstance(tup, dict) else tup))
                for tup in payload["scales"]]
    variables = payload.get("ema") or payload["variables"]
    return extract_scales(variables["params"])
