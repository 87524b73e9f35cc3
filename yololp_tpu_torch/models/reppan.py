"""RepBiFPANNeck in NCHW (mirrors yololp_tpu/models/reppan.py:67-100).

BiFusion top-down over (P2, P3, P4, P5), then stride-2 bottom-up, emitting
[P3 (s8), P4 (s16), P5 (s32)] maps. channels_list is the scaled concatenation
of the backbone's 5 and the neck's 6 out_channels.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from yololp_tpu_torch.layers.blocks import BiFusion, RepBlock, RepVGGBlock, SimConv


class RepBiFPANNeck(nn.Module):
    """BiFusion PAN — the LP neck; consumes (P2, P3, P4, P5)."""

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, deploy: bool = False):
        super().__init__()
        cl, nr = channels_list, num_repeats
        simconv = functools.partial(SimConv, deploy=deploy)
        rep = functools.partial(RepBlock, block=block, deploy=deploy)
        # inputs: P2 cl[1], P3 cl[2], P4 cl[3], P5 cl[4]
        self.reduce_layer0 = simconv(cl[4], cl[5], 1, 1)
        self.Bifusion0 = BiFusion((cl[5], cl[3], cl[2]), cl[5], deploy=deploy)
        self.Rep_p4 = rep(cl[5], cl[5], n=nr[5])
        self.reduce_layer1 = simconv(cl[5], cl[6], 1, 1)
        self.Bifusion1 = BiFusion((cl[6], cl[2], cl[1]), cl[6], deploy=deploy)
        self.Rep_p3 = rep(cl[6], cl[6], n=nr[6])
        self.downsample2 = simconv(cl[6], cl[7], 3, 2)
        self.Rep_n3 = rep(cl[7] + cl[6], cl[8], n=nr[7])
        self.downsample1 = simconv(cl[8], cl[9], 3, 2)
        self.Rep_n4 = rep(cl[9] + cl[5], cl[10], n=nr[8])
        self.out_channels = [cl[6], cl[8], cl[10]]

    def forward(self, xs):
        x3, x2, x1, x0 = xs  # (P2 s4, P3 s8, P4 s16, P5 s32)
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p4(self.Bifusion0([fpn_out0, x1, x2]))
        fpn_out1 = self.reduce_layer1(f_out0)
        pan_out2 = self.Rep_p3(self.Bifusion1([fpn_out1, x2, x3]))
        down1 = self.downsample2(pan_out2)
        pan_out1 = self.Rep_n3(torch.cat([down1, fpn_out1], 1))
        down0 = self.downsample1(pan_out1)
        pan_out0 = self.Rep_n4(torch.cat([down0, fpn_out0], 1))
        return [pan_out2, pan_out1, pan_out0]
