"""Layer/block primitives in NCHW (mirrors yololp_tpu/layers/blocks.py).

Every block takes its input channel count explicitly (flax infers it) and a
`deploy` flag. In deploy mode Conv+BN pairs and the 3-branch RepVGG block are
one biased conv; the matching state transform lives in layers/fuse.py.

Naming contract (relied on by fuse.py and utils/convert.py, and identical to
the JAX package's module tree): a fusible Conv+BN pair is always submodules
named 'conv' + 'bn'; RepVGG branches are 'rbr_dense_conv', 'rbr_dense_bn',
'rbr_1x1_conv', 'rbr_1x1_bn', 'rbr_identity_bn'; the deploy conv is 'conv'.

Stride-2 convs pad k//2 on both sides, and max-pool pads with -inf, as in
the JAX package.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Reference BN hyperparams: eps=1e-3, torch momentum=0.03.
BN_EPS = 1e-3
BN_MOMENTUM = 0.03

_ACTS = {"relu": nn.ReLU, "silu": nn.SiLU, None: nn.Identity}


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose training step updates the running statistics as flax
    does: with the biased batch variance (torch's own update uses the
    unbiased one), as `0.97 * running + (1 - 0.97) * batch`. The output is
    torch's (the batch is normalized by its biased variance in both)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean * (1.0 - keep))
            self.running_var.mul_(keep).add_(var * (1.0 - keep))
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBNAct(nn.Module):
    """Conv + BN + activation (reference Conv=SiLU / SimConv=ReLU).

    deploy=True replaces conv+BN with a single biased conv. conv_bias=True
    keeps a conv bias *and* BN, as the reference's conv wrappers do.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, act: str | None = "silu",
                 conv_bias: bool = False, deploy: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding=kernel_size // 2, groups=groups,
                              bias=conv_bias or deploy)
        self.bn = None if deploy else batch_norm(out_channels)
        self.act = _ACTS[act]()

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return self.act(y)


SimConv = functools.partial(ConvBNAct, act="relu")


class RepVGGBlock(nn.Module):
    """3-branch structural-reparameterization block.

    Train graph: 3x3 conv+BN + 1x1 conv+BN + (identity BN when in==out and
    stride==1), summed then ReLU. Deploy graph: one biased 3x3 conv + ReLU.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1,
                                  groups=groups, bias=True)
            return
        self.rbr_dense_conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1,
                                        groups=groups, bias=False)
        self.rbr_dense_bn = batch_norm(out_channels)
        self.rbr_1x1_conv = nn.Conv2d(in_channels, out_channels, 1, stride, 0,
                                      groups=groups, bias=False)
        self.rbr_1x1_bn = batch_norm(out_channels)
        self.rbr_identity_bn = (batch_norm(out_channels)
                                if in_channels == out_channels and stride == 1 else None)

    def forward(self, x):
        if self.deploy:
            return F.relu(self.conv(x))
        y = self.rbr_dense_bn(self.rbr_dense_conv(x)) + self.rbr_1x1_bn(self.rbr_1x1_conv(x))
        if self.rbr_identity_bn is not None:
            y = y + self.rbr_identity_bn(x)
        return F.relu(y)


class RepBlock(nn.Module):
    """Stage of n rep-style blocks: 'conv1' then 'block_0' .. 'block_{n-2}'."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 block=RepVGGBlock, deploy: bool = False):
        super().__init__()
        self.conv1 = block(in_channels, out_channels, deploy=deploy)
        self.n = n
        for i in range(n - 1):
            self.add_module(f"block_{i}", block(out_channels, out_channels, deploy=deploy))

    def forward(self, x):
        x = self.conv1(x)
        for i in range(self.n - 1):
            x = getattr(self, f"block_{i}")(x)
        return x


def _max_pool5(x):
    if x.dtype == torch.int8:
        # int8 codes (an int8 handoff through the SPPF) pool in bf16, which
        # holds every code exactly: CUDA's max-pool may not take int8
        return F.max_pool2d(x.to(torch.bfloat16), 5, stride=1, padding=2).to(torch.int8)
    return F.max_pool2d(x, 5, stride=1, padding=2)


class SPPFBase(nn.Module):
    """SPPF: 1x1 reduce, 3 stacked 5x5 maxpools, 1x1 out."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 deploy: bool = False):
        super().__init__()
        c_ = in_channels // 2
        self.cv1 = ConvBNAct(in_channels, c_, 1, 1, act=act, deploy=deploy)
        self.cv2 = ConvBNAct(4 * c_, out_channels, 1, 1, act=act, deploy=deploy)

    def forward(self, x):
        x = self.cv1(x)
        y1 = _max_pool5(x)
        y2 = _max_pool5(y1)
        y3 = _max_pool5(y2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


SimSPPF = functools.partial(SPPFBase, act="relu")
SPPF = functools.partial(SPPFBase, act="silu")


class CSPSPPFBase(nn.Module):
    """CSP-SPPF (reference common.py:124/149)."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5,
                 act: str = "relu", deploy: bool = False):
        super().__init__()
        c_ = int(out_channels * e)
        cba = functools.partial(ConvBNAct, act=act, deploy=deploy)
        self.cv1 = cba(in_channels, c_, 1, 1)
        self.cv3 = cba(c_, c_, 3, 1)
        self.cv4 = cba(c_, c_, 1, 1)
        self.cv2 = cba(in_channels, c_, 1, 1)
        self.cv5 = cba(4 * c_, c_, 1, 1)
        self.cv6 = cba(c_, c_, 3, 1)
        self.cv7 = cba(2 * c_, out_channels, 1, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y0 = self.cv2(x)
        y1 = _max_pool5(x1)
        y2 = _max_pool5(y1)
        y3 = _max_pool5(y2)
        m = self.cv6(self.cv5(torch.cat([x1, y1, y2, y3], 1)))
        return self.cv7(torch.cat([y0, m], 1))


SimCSPSPPF = functools.partial(CSPSPPFBase, act="relu")
CSPSPPF = functools.partial(CSPSPPFBase, act="silu")


class Transpose(nn.Module):
    """2x learnable upsample via ConvTranspose(k=2, s=2)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(in_channels, out_channels, 2, 2,
                                                     bias=True)

    def forward(self, x):
        return self.upsample_transpose(x)


class BiFusion(nn.Module):
    """BiFusion neck block: 2x upsample of the deep map + 1x1-reduced
    same-level map + stride-2 downsample of the shallow map, concat, 1x1."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 deploy: bool = False):
        super().__init__()
        deep_c, same_c, shallow_c = in_channels
        cba = functools.partial(ConvBNAct, act="relu", deploy=deploy)
        self.upsample = Transpose(deep_c, out_channels)
        self.cv1 = cba(same_c, out_channels, 1, 1)
        self.cv2 = cba(shallow_c, out_channels, 1, 1)
        self.downsample = cba(out_channels, out_channels, 3, 2)
        self.cv3 = cba(3 * out_channels, out_channels, 1, 1)

    def forward(self, xs):
        deep, same, shallow = xs
        x0 = self.upsample(deep)
        x1 = self.cv1(same)
        x2 = self.downsample(self.cv2(shallow))
        return self.cv3(torch.cat([x0, x1, x2], 1))


def get_block(mode: str):
    """Training-mode block selector; only 'repvgg' (the LP configs') is ported."""
    blocks = {"repvgg": RepVGGBlock}
    if mode not in blocks:
        raise NotImplementedError(
            f"training_mode {mode!r} is not ported yet; available: {sorted(blocks)}")
    return blocks[mode]
