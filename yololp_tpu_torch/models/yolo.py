"""Model assembly: config -> backbone + neck + head (mirrors
yololp_tpu/models/yolo.py:45-120).

Repeats scale by depth_multiple (round(i*d), min 1, for i>1) and channels by
width_multiple with make_divisible(x, 8). Input is NCHW float in [0, 1];
output in eval mode is the (B, A, 290) decode.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from yololp_tpu_torch.layers.blocks import get_block
from yololp_tpu_torch.models.effidehead import Detect
from yololp_tpu_torch.models.efficientrep import EfficientRep
from yololp_tpu_torch.models.reppan import RepBiFPANNeck
from yololp_tpu_torch.utils.device import resolve_device

BACKBONES = {"EfficientRep": EfficientRep}
NECKS = {"RepBiFPANNeck": RepBiFPANNeck}


def make_divisible(x, divisor=8):
    return int(math.ceil(x / divisor) * divisor)


def scaled_lists(config):
    """Apply depth/width multipliers."""
    m = config["model"]
    depth_mul = m["depth_multiple"]
    width_mul = m["width_multiple"]
    num_repeat = [
        (max(round(i * depth_mul), 1) if i > 1 else i)
        for i in (list(m["backbone"]["num_repeats"])
                  + list(m["neck"]["num_repeats"]))
    ]
    channels_list = [
        make_divisible(i * width_mul, 8)
        for i in (list(m["backbone"]["out_channels"])
                  + list(m["neck"]["out_channels"]))
    ]
    return num_repeat, channels_list


def _lookup(registry, kind, name):
    if name not in registry:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported yet; available: {sorted(registry)}")
    return registry[name]


class Model(nn.Module):
    """backbone -> neck -> head; eval forward returns (B, A, 290)."""

    def __init__(self, config, npro: int = 31, nalp: int = 24, nads: int = 37,
                 deploy: bool = False):
        super().__init__()
        self.config, self.npro, self.nalp, self.nads = config, npro, nalp, nads
        self.deploy = deploy
        num_repeat, channels_list = scaled_lists(config)
        mcfg = config["model"]
        block = get_block(config.get("training_mode", "repvgg"))
        self.backbone = _lookup(BACKBONES, "backbone", mcfg["backbone"]["type"])(
            channels_list, num_repeat, block=block,
            fuse_P2=bool(mcfg["backbone"].get("fuse_P2")),
            cspsppf=bool(mcfg["backbone"].get("cspsppf")), deploy=deploy)
        self.neck = _lookup(NECKS, "neck", mcfg["neck"]["type"])(
            channels_list, num_repeat, block=block, deploy=deploy)
        self.detect = Detect(
            self.neck.out_channels, npro=npro, nalp=nalp, nads=nads,
            num_layers=mcfg["head"]["num_layers"],
            use_dfl=bool(mcfg["head"]["use_dfl"]),
            reg_max=int(mcfg["head"]["reg_max"]), deploy=deploy)

    def rebuild(self, deploy: bool) -> "Model":
        """A fresh model of the same config in the given graph."""
        return Model(self.config, self.npro, self.nalp, self.nads, deploy=deploy)

    def forward(self, x):
        return self.detect(self.neck(self.backbone(x)))


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator):
    """Draw the initial weights from `generator`, as the JAX init does:
    truncated-normal LeCun kernels, zero biases, identity BN, and the head's
    zero pred kernels with the prior-prob bias."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            # flax lecun_normal: truncated at 2 sigma, rescaled to unit variance
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, Detect):
            m.reset_pred_parameters()


def build_model(config, npro: int = 31, nalp: int = 24, nads: int = 37,
                deploy: bool = False, seed: int = 0, device="cuda") -> Model:
    """Instantiate the model with weights drawn from `seed`, in eval mode."""
    dev = resolve_device(device)
    model = Model(config, npro=npro, nalp=nalp, nads=nads, deploy=deploy)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
