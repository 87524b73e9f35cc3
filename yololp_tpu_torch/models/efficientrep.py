"""EfficientRep backbone in NCHW (mirrors yololp_tpu/models/efficientrep.py:29-64).

Stem (stride-2 rep block), then ERBlock_2..5: each a stride-2 rep block and a
RepBlock stage; the deepest stage appends an SPPF variant. With fuse_P2 the
stride-4 ERBlock_2 output is emitted too (used by RepBiFPANNeck).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from yololp_tpu_torch.layers.blocks import (
    RepBlock,
    RepVGGBlock,
    SimCSPSPPF,
    SimSPPF,
)

_STAGES = ("ERBlock_2", "ERBlock_3", "ERBlock_4", "ERBlock_5")


class EfficientRep(nn.Module):
    """Rep-style backbone with 3, or 4 (with P2), outputs."""

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, fuse_P2: bool = False, cspsppf: bool = False,
                 deploy: bool = False, in_channels: int = 3):
        super().__init__()
        cl, nr = channels_list, num_repeats
        self.fuse_P2 = fuse_P2
        self.stem = block(in_channels, cl[0], stride=2, deploy=deploy)
        prev = cl[0]
        for i, stage in enumerate(_STAGES):
            c = cl[i + 1]
            self.add_module(f"{stage}_down", block(prev, c, stride=2, deploy=deploy))
            self.add_module(f"{stage}_rep", RepBlock(c, c, n=nr[i + 1], block=block,
                                                     deploy=deploy))
            prev = c
        sppf = SimCSPSPPF if cspsppf else SimSPPF
        self.ERBlock_5_sppf = sppf(prev, prev, deploy=deploy)
        self.out_channels = list(cl[1:5] if fuse_P2 else cl[2:5])

    def forward(self, x):
        outputs = []
        x = self.stem(x)
        for stage in _STAGES:
            x = getattr(self, f"{stage}_down")(x)
            x = getattr(self, f"{stage}_rep")(x)
            if stage == "ERBlock_5":
                x = self.ERBlock_5_sppf(x)
            if stage != "ERBlock_2" or self.fuse_P2:
                outputs.append(x)
        return tuple(outputs)
