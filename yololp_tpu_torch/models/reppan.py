"""Necks in NCHW: RepPANNeck / RepBiFPANNeck, their P6 and CSP variants
(mirrors yololp_tpu/models/reppan.py, 8 classes).

Top-down, each deeper map is reduced by a 1x1 SimConv, brought up 2x and
merged with the next shallower backbone map: by a ConvTranspose then a
concat (the PAN necks), or by a BiFusion that also takes the map one level
shallower at stride 2 (the BiFPAN necks, which consume P2). Then stride-2
SimConvs go bottom-up, each concatenated with the reduced map of its level.
Every stage is a RepBlock, or a BepC3 in the CSP necks. In the P6 necks
the bottom-up step that makes the stride-64 output (downsample0, Rep_n6) is
the span `model.neck.p6` (utils/profiler.py).

channels_list is the scaled concatenation of the backbone's 5 (6 for P6)
and the neck's 6 out_channels, indexed as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import torch
from torch import nn

from yololp_tpu_torch.layers.blocks import BepC3, BiFusion, RepBlock, RepVGGBlock, SimConv, Transpose
from yololp_tpu_torch.utils.profiler import annotate


class _Neck(nn.Module):
    """The shared PAN. `BIFUSION` selects the top-down merge, `P6` the
    level count; `csp_e` set makes every stage a BepC3."""

    BIFUSION = False
    P6 = False

    def __init__(self, channels_list: Sequence[int], num_repeats: Sequence[int],
                 block=RepVGGBlock, csp_e: Optional[float] = None, deploy: bool = False):
        super().__init__()
        cl, nr = channels_list, num_repeats
        simconv = functools.partial(SimConv, deploy=deploy)
        if csp_e is None:
            stage = functools.partial(RepBlock, block=block, deploy=deploy)
        else:
            stage = functools.partial(BepC3, e=csp_e, block=block, deploy=deploy)
        nb = 6 if self.P6 else 5            # backbone entries of channels_list
        k = nb - 3                          # top-down steps
        # backbone maps deepest first: P5 (P6) .. P3 (P2)
        bb = [cl[nb - 1 - j] for j in range(nb - 1)]
        self.top = [f"Rep_p{k + 2 - j}" for j in range(k)]  # Rep_p4, Rep_p3 (P6: Rep_p5 ..)
        c_in = bb[0]
        for j in range(k):
            c = cl[nb + j]
            self.add_module(f"reduce_layer{j}", simconv(c_in, c, 1, 1))
            if self.BIFUSION:
                self.add_module(f"Bifusion{j}", BiFusion((c, bb[j + 1], bb[j + 2]), c,
                                                         deploy=deploy))
                c_stage = c
            else:
                self.add_module(f"upsample{j}", Transpose(c, c))
                c_stage = c + bb[j + 1]
            self.add_module(self.top[j], stage(c_stage, c, n=nr[nb + j]))
            c_in = c
        # bottom-up: P5 necks downsample2 -> Rep_n3, downsample1 -> Rep_n4;
        # P6 necks downsample2 -> Rep_n4, ..1 -> Rep_n5, ..0 -> Rep_n6
        self.bottom = [(f"downsample{2 - j}", f"Rep_n{k + 1 + j}") for j in range(k)]
        c_prev = cl[nb + k - 1]
        self.out_channels = [c_prev]
        for j, (down, rep) in enumerate(self.bottom):
            if self.P6:
                c_down, c_out = c_prev, cl[nb + k + j]
            else:
                c_down, c_out = cl[nb + k + 2 * j], cl[nb + k + 2 * j + 1]
            c_lat = cl[nb + k - 1 - j]  # the reduced map of this level
            self.add_module(down, simconv(c_prev, c_down, 3, 2))
            self.add_module(rep, stage(c_down + c_lat, c_out, n=nr[nb + k + j]))
            self.out_channels.append(c_out)
            c_prev = c_out

    def forward(self, xs):
        xs = list(xs)[::-1]  # deepest first
        fpn, x = [], xs[0]
        for j, name in enumerate(self.top):
            f = getattr(self, f"reduce_layer{j}")(x)
            fpn.append(f)
            if self.BIFUSION:
                merged = getattr(self, f"Bifusion{j}")([f, xs[j + 1], xs[j + 2]])
            else:
                merged = torch.cat([getattr(self, f"upsample{j}")(f), xs[j + 1]], 1)
            x = getattr(self, name)(merged)
        outs = [x]
        for j, (down, rep) in enumerate(self.bottom):
            # downsample0 is the P6 necks' stride-64 step
            with (annotate("model.neck.p6", x.device) if down == "downsample0"
                  else contextlib.nullcontext()):
                x = getattr(self, rep)(torch.cat([getattr(self, down)(x), fpn[-1 - j]], 1))
            outs.append(x)
        return outs


class RepPANNeck(_Neck):
    """Classic PAN with ConvTranspose upsample + concat."""


class RepBiFPANNeck(_Neck):
    """BiFusion PAN, the LP neck; consumes (P2, P3, P4, P5)."""

    BIFUSION = True


class RepPANNeck6(_Neck):
    """P6 PAN: 4 inputs (P3..P6), 4 outputs."""

    P6 = True


class RepBiFPANNeck6(_Neck):
    """P6 BiFusion PAN: 5 inputs (P2..P6), 4 outputs."""

    BIFUSION = True
    P6 = True


class _CSP:
    """The CSP necks take csp_e (their stages are BepC3)."""

    def __init__(self, channels_list, num_repeats, block=RepVGGBlock, csp_e: float = 0.5,
                 deploy: bool = False):
        super().__init__(channels_list, num_repeats, block=block, csp_e=csp_e, deploy=deploy)


class CSPRepPANNeck(_CSP, RepPANNeck):
    """RepPANNeck with BepC3 stages (m/l models)."""


class CSPRepBiFPANNeck(_CSP, RepBiFPANNeck):
    """RepBiFPANNeck with BepC3 stages."""


class CSPRepPANNeck_P6(_CSP, RepPANNeck6):
    """P6 CSP PAN."""


class CSPRepBiFPANNeck_P6(_CSP, RepBiFPANNeck6):
    """P6 CSP BiFusion PAN."""
