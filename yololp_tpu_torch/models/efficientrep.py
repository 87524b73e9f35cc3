"""Backbones in NCHW: EfficientRep (+P6) and CSPBepBackbone (+P6)
(mirrors yololp_tpu/models/efficientrep.py).

Stem (stride-2 block), then ERBlock_2..5 (..6 for P6): each a stride-2
block and a stage, a RepBlock ('{stage}_rep') or, in the CSP backbones, a
BepC3 ('{stage}_csp'); the deepest stage appends an SPPF variant. With
fuse_P2 the stride-4 ERBlock_2 output is emitted too (used by the BiFPAN
necks). In the P6 backbones the stride-64 stage (ERBlock_6's down block,
stage and SPPF) is the span `model.backbone.p6` (utils/profiler.py).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

from torch import nn

from yololp_tpu_torch.layers.blocks import (
    CSPSPPF,
    SPPF,
    BepC3,
    ConvWrapper,
    RepBlock,
    RepVGGBlock,
    SimCSPSPPF,
    SimSPPF,
)
from yololp_tpu_torch.utils.profiler import annotate


def _sppf_cls(block, cspsppf: bool):
    """The SPPF of a P5 backbone: SiLU for ConvWrapper blocks, else ReLU."""
    if cspsppf:
        return CSPSPPF if block is ConvWrapper else SimCSPSPPF
    return SPPF if block is ConvWrapper else SimSPPF


class _Backbone(nn.Module):
    """The shared stage structure. Subclasses set the stage count, the stage
    kind and the SPPF rule."""

    P6 = False
    CSP = False

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, csp_e: float = 0.5, fuse_P2: bool = False,
                 cspsppf: bool = False, deploy: bool = False, in_channels: int = 3):
        super().__init__()
        cl, nr = channels_list, num_repeats
        self.fuse_P2 = fuse_P2
        self.stages = [f"ERBlock_{i}" for i in range(2, 7 if self.P6 else 6)]
        self.stem = block(in_channels, cl[0], stride=2, deploy=deploy)
        prev = cl[0]
        for i, stage in enumerate(self.stages):
            c = cl[i + 1]
            self.add_module(f"{stage}_down", block(prev, c, stride=2, deploy=deploy))
            if self.CSP:
                self.add_module(f"{stage}_csp", BepC3(c, c, n=nr[i + 1], e=csp_e, block=block,
                                                      deploy=deploy))
            else:
                self.add_module(f"{stage}_rep", RepBlock(c, c, n=nr[i + 1], block=block,
                                                         deploy=deploy))
            prev = c
        # the P6 backbones keep the ReLU SPPF whatever the block
        sppf = ((SimCSPSPPF if cspsppf else SimSPPF) if self.P6
                else _sppf_cls(block, cspsppf))
        self.add_module(f"{self.stages[-1]}_sppf", sppf(prev, prev, deploy=deploy))
        n = len(self.stages)
        self.out_channels = list(cl[1:n + 1] if fuse_P2 else cl[2:n + 1])

    def forward(self, x):
        outputs = []
        x = self.stem(x)
        kind = "_csp" if self.CSP else "_rep"
        for stage in self.stages:
            with (annotate("model.backbone.p6", x.device) if stage == "ERBlock_6"
                  else contextlib.nullcontext()):
                x = getattr(self, f"{stage}_down")(x)
                x = getattr(self, stage + kind)(x)
                if stage == self.stages[-1]:
                    x = getattr(self, f"{stage}_sppf")(x)
            if stage != "ERBlock_2" or self.fuse_P2:
                outputs.append(x)
        return tuple(outputs)


class EfficientRep(_Backbone):
    """Rep-style backbone with 3, or 4 (with P2), outputs."""


class EfficientRep6(_Backbone):
    """P6 variant: adds the stride-64 ERBlock_6 and its SPPF."""

    P6 = True


class CSPBepBackbone(_Backbone):
    """CSP (BepC3) backbone of the m/l models."""

    CSP = True


class CSPBepBackbone_P6(_Backbone):
    """CSP P6 backbone."""

    P6 = True
    CSP = True
