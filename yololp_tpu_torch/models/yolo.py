"""Model assembly: config -> backbone + neck + head (mirrors
yololp_tpu/models/yolo.py:45-120).

Repeats scale by depth_multiple (round(i*d), min 1, for i>1) and channels by
width_multiple with make_divisible(x, 8). Input is NCHW float in [0, 1];
output in eval mode is the (B, A, 290) decode, in training mode the head's
HeadTrainOutput (models/effidehead.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from yololp_tpu_torch.layers.blocks import BottleRep, ScaleLayer, get_block
from yololp_tpu_torch.models import efficientrep as _bb
from yololp_tpu_torch.models import reppan as _nk
from yololp_tpu_torch.models.effidehead import Detect
from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import annotate

BACKBONES = {
    "EfficientRep": _bb.EfficientRep,
    "EfficientRep6": _bb.EfficientRep6,
    "CSPBepBackbone": _bb.CSPBepBackbone,
    "CSPBepBackbone_P6": _bb.CSPBepBackbone_P6,
}

NECKS = {
    "RepPANNeck": _nk.RepPANNeck,
    "RepBiFPANNeck": _nk.RepBiFPANNeck,
    "RepPANNeck6": _nk.RepPANNeck6,
    "RepBiFPANNeck6": _nk.RepBiFPANNeck6,
    "CSPRepPANNeck": _nk.CSPRepPANNeck,
    "CSPRepBiFPANNeck": _nk.CSPRepBiFPANNeck,
    "CSPRepPANNeck_P6": _nk.CSPRepPANNeck_P6,
    "CSPRepBiFPANNeck_P6": _nk.CSPRepBiFPANNeck_P6,
}


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


class Model(nn.Module):
    """backbone -> neck -> head; the eval forward returns (B, A, 290), the
    train forward (`.train()`) a HeadTrainOutput."""

    def __init__(self, config, npro: int = 31, nalp: int = 24, nads: int = 37,
                 deploy: bool = False):
        super().__init__()
        self.config, self.npro, self.nalp, self.nads = config, npro, nalp, nads
        self.deploy = deploy
        num_repeat, channels_list = scaled_lists(config)
        mcfg = config["model"]
        block = get_block(config.get("training_mode", "repvgg"))
        bb, nk = mcfg["backbone"], mcfg["neck"]
        bb_kw = dict(block=block, fuse_P2=bool(bb.get("fuse_P2")),
                     cspsppf=bool(bb.get("cspsppf")), deploy=deploy)
        if "CSP" in bb["type"]:
            bb_kw["csp_e"] = bb["csp_e"]
        self.backbone = BACKBONES[bb["type"]](channels_list, num_repeat, **bb_kw)
        nk_kw = dict(block=block, deploy=deploy)
        if "CSP" in nk["type"]:
            nk_kw["csp_e"] = nk["csp_e"]
        self.neck = NECKS[nk["type"]](channels_list, num_repeat, **nk_kw)
        self.detect = Detect(
            self.neck.out_channels, npro=npro, nalp=nalp, nads=nads,
            num_layers=mcfg["head"]["num_layers"],
            use_dfl=bool(mcfg["head"]["use_dfl"]),
            reg_max=int(mcfg["head"]["reg_max"]), deploy=deploy)

    def rebuild(self, deploy: bool) -> "Model":
        """A fresh model of the same config in the given graph."""
        return Model(self.config, self.npro, self.nalp, self.nads, deploy=deploy)

    def forward(self, x):
        dev = x.device
        with annotate("model.backbone", dev):
            x = self.backbone(x)
        with annotate("model.neck", dev):
            x = self.neck(x)
        return self.detect(x)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator):
    """Draw the initial weights from `generator`, as the JAX init does:
    truncated-normal LeCun kernels, zero biases, identity BN, ScaleLayers
    at their scale_init, BottleRep alphas at one, and the head's zero pred
    kernels with the prior-prob bias."""
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
        elif isinstance(m, ScaleLayer):
            m.weight.fill_(m.scale_init)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BottleRep) and m.alpha is not None:
            m.alpha.fill_(1.0)
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
