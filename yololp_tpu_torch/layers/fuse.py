"""Structural reparameterization on state dicts (mirrors
yololp_tpu/layers/fuse.py:28-128).

The JAX package folds its param tree by the naming contract of
layers/blocks.py; this module does the same on a torch state dict (OIHW
kernels), nested by module path:

  * RepVGG branches             -> one biased 'conv'
  * LinearAddBlock (CSLA)       -> one biased 'conv'
  * sibling 'conv' + 'bn' pair  -> biased 'conv' (BN removed)

A LinearAddBlock also holds a 'conv' and a 'bn', so its pattern is tested
before the generic pair (folding that pair alone would drop its 1x1 branch
and its scales).

Everything else passes through. The arithmetic follows the JAX fold in the
same order and in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from yololp_tpu_torch.layers.blocks import BN_EPS
from yololp_tpu_torch.utils.convert import jax_to_state_dict, state_dict_to_jax

_REPVGG_KEYS = {"rbr_dense_conv", "rbr_dense_bn", "rbr_1x1_conv", "rbr_1x1_bn"}
_LINEARADD_KEYS = {"conv", "scale_conv", "conv_1x1", "scale_1x1", "bn"}


def fold_conv_bn(weight: torch.Tensor, bn: Dict[str, torch.Tensor],
                 conv_bias: Optional[torch.Tensor] = None, eps: float = BN_EPS):
    """Fold BatchNorm(conv(x) + b0) into (weight', bias'). weight is OIHW;
    bn holds 'weight', 'bias', 'running_mean', 'running_var'."""
    weight = weight.float()
    t = bn["weight"].float() / torch.sqrt(bn["running_var"].float() + eps)
    fused_weight = weight * t.reshape(-1, 1, 1, 1)
    b0 = conv_bias.float() if conv_bias is not None else 0.0
    fused_bias = (b0 - bn["running_mean"].float()) * t + bn["bias"].float()
    return fused_weight, fused_bias


def _identity_kernel_3x3(in_channels: int, out_channels: int, groups: int = 1):
    """Dirac 3x3 kernel (OIHW) equal to the identity map."""
    input_dim = in_channels // groups
    k = torch.zeros(out_channels, input_dim, 3, 3)
    for o in range(out_channels):
        k[o, o % input_dim, 1, 1] = 1.0
    return k


def fold_repvgg(node: Dict) -> Dict:
    """Fuse the 3 RepVGG branches of one block into one biased 3x3 conv."""
    k3, b3 = fold_conv_bn(node["rbr_dense_conv"]["weight"], node["rbr_dense_bn"])
    k1, b1 = fold_conv_bn(node["rbr_1x1_conv"]["weight"], node["rbr_1x1_bn"])
    weight = k3 + F.pad(k1, (1, 1, 1, 1))
    bias = b3 + b1
    if "rbr_identity_bn" in node:
        kid = _identity_kernel_3x3(k3.shape[1], k3.shape[0]).to(k3.device)
        ki, bi = fold_conv_bn(kid, node["rbr_identity_bn"])
        weight = weight + ki
        bias = bias + bi
    return {"conv": {"weight": weight, "bias": bias}}


def fold_linear_add(node: Dict) -> Dict:
    """Fuse a LinearAddBlock into one biased 3x3 conv: the kernel
    scale_conv * k3 + pad(scale_1x1 * k1) [+ scale_identity * I], then the
    shared BN folded in."""
    k3 = node["conv"]["weight"].float()
    k1 = node["conv_1x1"]["weight"].float()
    col = lambda s: s.float().reshape(-1, 1, 1, 1)  # noqa: E731  (per output channel)
    weight = k3 * col(node["scale_conv"]["weight"]) + F.pad(
        k1 * col(node["scale_1x1"]["weight"]), (1, 1, 1, 1))
    if "scale_identity" in node:
        kid = _identity_kernel_3x3(k3.shape[1], k3.shape[0]).to(k3.device)
        weight = weight + kid * col(node["scale_identity"]["weight"])
    weight, bias = fold_conv_bn(weight, node["bn"])
    return {"conv": {"weight": weight, "bias": bias}}


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return tree


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _is_conv_leaf(node) -> bool:
    return isinstance(node, dict) and "weight" in node and node["weight"].dim() == 4


def fuse_tree(node):
    """Recursively fold every fusible pattern of a nested state dict."""
    if not isinstance(node, dict):
        return node
    keys = set(node)
    if _REPVGG_KEYS <= keys:
        return fold_repvgg(node)
    if _LINEARADD_KEYS <= keys:
        return fold_linear_add(node)
    out = {}
    if "conv" in keys and "bn" in keys and _is_conv_leaf(node["conv"]):
        weight, bias = fold_conv_bn(node["conv"]["weight"], node["bn"],
                                    conv_bias=node["conv"].get("bias"))
        out["conv"] = {"weight": weight, "bias": bias}
        keys -= {"conv", "bn"}
    for k in keys:
        out[k] = fuse_tree(node[k])
    return out


def fuse_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Train-graph state dict -> the deploy graph's state dict."""
    return _flatten(fuse_tree(_nest(state_dict)))


def fuse_variables(variables: Dict) -> Dict:
    """The JAX package's `fuse_variables` on its own trees: train-format
    {'params', 'batch_stats'} (numpy leaves) -> the deploy {'params'}, by
    way of the port's state dict (utils/convert.py) and `fuse_state_dict`."""
    return state_dict_to_jax(fuse_state_dict(jax_to_state_dict(variables)))


def fuse_model(model):
    """Return the deploy-graph copy of a train-graph `models.yolo.Model`,
    on the same device, in eval mode."""
    deploy = model.rebuild(deploy=True)
    deploy.load_state_dict(fuse_state_dict(model.state_dict()))
    return deploy.to(next(model.parameters()).device).eval()
