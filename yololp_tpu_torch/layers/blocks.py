"""Layer/block primitives in NCHW (mirrors yololp_tpu/layers/blocks.py).

Every block takes its input channel count explicitly (flax infers it) and a
`deploy` flag. In deploy mode Conv+BN pairs and the 3-branch RepVGG block are
one biased conv; the matching state transform lives in layers/fuse.py.

Naming contract (relied on by fuse.py and utils/convert.py, and identical to
the JAX package's module tree): a fusible Conv+BN pair is always submodules
named 'conv' + 'bn'; RepVGG branches are 'rbr_dense_conv', 'rbr_dense_bn',
'rbr_1x1_conv', 'rbr_1x1_bn', 'rbr_identity_bn'; the deploy conv is 'conv'.
A LinearAddBlock holds 'conv', 'conv_1x1', 'scale_conv', 'scale_1x1'
['scale_identity'] and 'bn'; a RealVGGBlock one ConvBNAct named 'cell'.

Stride-2 convs pad k//2 on both sides, and max-pool pads with -inf, as in
the JAX package.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yololp_tpu_torch.ops import cuda_bias_act
from yololp_tpu_torch.parallel.mesh import global_sum_grad, world_size
from yololp_tpu_torch.utils import profiler

# Reference BN hyperparams: eps=1e-3, torch momentum=0.03.
BN_EPS = 1e-3
BN_MOMENTUM = 0.03

_ACTS = {"relu": nn.ReLU, "silu": nn.SiLU, None: nn.Identity}
# an activation module's type -> the epilogue's act number, and its function
_ACT_CODES = {nn.Identity: cuda_bias_act.NONE, nn.ReLU: cuda_bias_act.RELU,
              nn.SiLU: cuda_bias_act.SILU}
_ACT_FNS = {cuda_bias_act.NONE: lambda y: y, cuda_bias_act.RELU: F.relu,
            cuda_bias_act.SILU: F.silu}


def _epilogue_fusable(conv: nn.Module, x: torch.Tensor) -> bool:
    """Whether `conv_act` may run `conv` without its bias and then the
    epilogue op: no gradient is recorded (the op has no backward), no
    autocast rewrites the conv's dtypes, the dtype is the kernel's and the
    bias's, and no hook on the conv waits to see its own call (calibration's
    and fake quantization's pre-hooks)."""
    if torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad
                                    or conv.bias.requires_grad):
        return False
    autocast = x.device.type in ("cpu", "cuda") and torch.is_autocast_enabled(x.device.type)
    return (x.dtype in cuda_bias_act.DTYPES and conv.bias.dtype == x.dtype and not autocast
            and not conv._forward_pre_hooks and not conv._forward_hooks)


def conv_act(conv: nn.Module, x: torch.Tensor, act: int, residual: torch.Tensor | None = None,
             alpha: torch.Tensor | None = None) -> torch.Tensor:
    """`act(conv(x))` for a biased `nn.Conv2d` or `nn.ConvTranspose2d`, `act`
    the epilogue's number (cuda_bias_act.NONE, RELU, SILU); with `residual`,
    a BottleRep's shortcut after it: `act(conv(x)) + alpha * residual` (alpha
    None reads as 1). Where `_epilogue_fusable` allows, the conv runs without
    its bias and `yololp_torch::bias_act` adds it and applies `act` in one
    pass (on the card one kernel in place of PyTorch's broadcast add and a
    separate activation; on the CPU its plain version), with `residual`
    its residual form, which adds the shortcut in that pass too (on the card
    always, raising on operands it does not take; on the CPU where the
    conv's output and `residual` are laid out alike); else `conv(x)`, the
    activation and the shortcut, as the train graph needs them. While spans
    record, counts `conv.biased` and, for the fused, `conv.epilogue_fused`,
    and `block.residual_fused` for a shortcut added in the pass. A conv of
    another type (an int8 plan's, which has its own epilogue) runs as it is,
    then `act`."""
    if not isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)):
        return _shortcut(_ACT_FNS[act](conv(x)), residual, alpha)
    fused = _epilogue_fusable(conv, x)
    if profiler.recording():
        profiler.count("conv.biased", 1)
        if fused:
            profiler.count("conv.epilogue_fused", 1)
    if not fused:
        return _shortcut(_ACT_FNS[act](conv(x)), residual, alpha)
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, conv.weight, None, conv.stride, conv.padding,
                               conv.output_padding, conv.groups, conv.dilation)
    else:
        y = conv._conv_forward(x, conv.weight, None)
    if residual is None:
        return cuda_bias_act.bias_act(y, conv.bias, act)
    alpha = y.new_ones(1) if alpha is None else alpha
    refused = y.device.type != "cuda" and cuda_bias_act.residual_refusal(y, residual, alpha)
    if refused:
        return _shortcut(cuda_bias_act.bias_act(y, conv.bias, act), residual, alpha)
    if profiler.recording():
        profiler.count("block.residual_fused", 1)
    return cuda_bias_act.bias_act(y, conv.bias, act, residual, alpha)


def _shortcut(y: torch.Tensor, residual: torch.Tensor | None, alpha: torch.Tensor | None):
    """y + alpha * residual, as a BottleRep adds its shortcut (y alone
    without one)."""
    if residual is None:
        return y
    return y + (alpha * residual if alpha is not None else residual)


def _hooked(m: nn.Module) -> bool:
    return bool(m._forward_pre_hooks or m._forward_hooks)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose training step updates the running statistics as flax
    does: with the biased batch variance (torch's own update uses the
    unbiased one), as `0.97 * running + (1 - 0.97) * batch`. The output is
    torch's (the batch is normalized by its biased variance in both).

    In a process group of more than one rank the batch is the global one,
    as flax's BN under pjit sees it: the per-channel count, sum and sum of
    squares are summed over the ranks (in fp32, or the input's wider type),
    the gradient flowing back through the sum to every rank's input. Not
    torch.nn.SyncBatchNorm, which updates the running variance with the
    unbiased variance."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if world_size() > 1:
            return self._global_batch_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.promote_types(x.dtype, torch.float32)),
                                       dim=(0, 2, 3), unbiased=False)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean, var):
        keep = 1.0 - self.momentum
        self.running_mean.mul_(keep).add_(mean * (1.0 - keep))
        self.running_var.mul_(keep).add_(var * (1.0 - keep))
        self.num_batches_tracked.add_(1)

    def _global_batch_forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype, device=xf.device)
        sums = global_sum_grad(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        with torch.no_grad():
            self._update_running(mean.detach(), var.detach())
        scale = self.weight.to(xf.dtype) * torch.rsqrt(var + self.eps)
        shift = self.bias.to(xf.dtype) - mean * scale
        return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def torch_pad(kernel_size: int):
    """The ((top, bottom), (left, right)) zero padding of a conv of
    `kernel_size`: k // 2 on every side, stride 2 included (the JAX
    package's padding spec; nn.Conv2d takes its (k // 2, k // 2))."""
    p = kernel_size // 2
    return ((p, p), (p, p))


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

    def deploy_conv(self):
        """(conv, act) when this block is one biased conv and its epilogue
        (deploy) and nothing hooks it, else None: a caller may then run the
        block as `conv_act(conv, x, act, ...)` in place of calling it."""
        if self.bn is None and not _hooked(self):
            return self.conv, _ACT_CODES[type(self.act)]
        return None

    def forward(self, x):
        if self.bn is None:
            return conv_act(self.conv, x, _ACT_CODES[type(self.act)])
        return self.act(self.bn(self.conv(x)))


SimConv = functools.partial(ConvBNAct, act="relu")
SiluConv = functools.partial(ConvBNAct, act="silu")


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

    def deploy_conv(self):
        """(conv, act) in deploy mode when nothing hooks the block, else
        None (ConvBNAct.deploy_conv)."""
        return (self.conv, cuda_bias_act.RELU) if self.deploy and not _hooked(self) else None

    def forward(self, x):
        if self.deploy:
            return conv_act(self.conv, x, cuda_bias_act.RELU)
        y = self.rbr_dense_bn(self.rbr_dense_conv(x)) + self.rbr_1x1_bn(self.rbr_1x1_conv(x))
        if self.rbr_identity_bn is not None:
            y = y + self.rbr_identity_bn(x)
        return F.relu(y)


class RealVGGBlock(nn.Module):
    """Plain conv-BN-ReLU, the RepOpt target net's block: one ConvBNAct
    named 'cell'."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 deploy: bool = False):
        super().__init__()
        self.cell = ConvBNAct(in_channels, out_channels, 3, stride, act="relu", deploy=deploy)

    def forward(self, x):
        return self.cell(x)


class ScaleLayer(nn.Module):
    """Per-channel learnable scale (parameter 'weight'), with an optional
    bias."""

    def __init__(self, channels: int, use_bias: bool = True, scale_init: float = 1.0):
        super().__init__()
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None

    def forward(self, x):
        y = x * self.weight.reshape(1, -1, 1, 1)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1)
        return y


class LinearAddBlock(nn.Module):
    """CSLA hyper-search block: scaled 3x3 + scaled 1x1 (+ scaled identity
    when in==out and stride==1), one shared BN, ReLU. Deploy graph: one
    biased 3x3 'conv' + ReLU (layers/fuse.py:fold_linear_add)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 conv_scale_init: float = 1.0, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=True)
            return
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)
        self.scale_conv = ScaleLayer(out_channels, use_bias=False, scale_init=conv_scale_init)
        self.conv_1x1 = nn.Conv2d(in_channels, out_channels, 1, stride, 0, bias=False)
        self.scale_1x1 = ScaleLayer(out_channels, use_bias=False, scale_init=conv_scale_init)
        self.scale_identity = (ScaleLayer(out_channels, use_bias=False, scale_init=1.0)
                               if in_channels == out_channels and stride == 1 else None)
        self.bn = batch_norm(out_channels)

    def forward(self, x):
        if self.deploy:
            return conv_act(self.conv, x, cuda_bias_act.RELU)
        y = self.scale_conv(self.conv(x)) + self.scale_1x1(self.conv_1x1(x))
        if self.scale_identity is not None:
            y = y + self.scale_identity(x)
        return F.relu(self.bn(y))


class ConvWrapper(nn.Module):
    """conv_silu mode block: a biased 3x3 conv + BN + SiLU, named 'block'."""

    act = "silu"

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 deploy: bool = False):
        super().__init__()
        self.block = ConvBNAct(in_channels, out_channels, 3, stride, act=self.act,
                               conv_bias=True, deploy=deploy)

    def deploy_conv(self):
        """Its ConvBNAct's (conv, act) when nothing hooks this block either
        (ConvBNAct.deploy_conv)."""
        return None if _hooked(self) else self.block.deploy_conv()

    def forward(self, x):
        return self.block(x)


class SimConvWrapper(ConvWrapper):
    """conv_relu mode block: a biased 3x3 conv + BN + ReLU, named 'block'."""

    act = "relu"


class BottleRep(nn.Module):
    """Two blocks, 'conv1' and 'conv2', with a residual when in==out; with
    weight=True the residual is scaled by a learnable 'alpha' of shape (1,).
    Where 'conv2' hands over its deploy conv (`deploy_conv`), the residual
    joins that conv's epilogue (`conv_act`); while spans record, each
    residual counts `block.residual`."""

    def __init__(self, in_channels: int, out_channels: int, block=RepVGGBlock,
                 weight: bool = False, deploy: bool = False):
        super().__init__()
        self.conv1 = block(in_channels, out_channels, deploy=deploy)
        self.conv2 = block(out_channels, out_channels, deploy=deploy)
        self.shortcut = in_channels == out_channels
        self.alpha = nn.Parameter(torch.ones(1)) if self.shortcut and weight else None

    def forward(self, x):
        h = self.conv1(x)
        if not self.shortcut:
            return self.conv2(h)
        if profiler.recording():
            profiler.count("block.residual", 1)
        # a block without the method (hyper-search, RepOpt, an int8 plan's swap) runs as itself
        hand_over = getattr(self.conv2, "deploy_conv", None)
        deploy = hand_over() if hand_over is not None else None
        if deploy is None:
            return _shortcut(self.conv2(h), x, self.alpha)
        conv, act = deploy
        return conv_act(conv, h, act, residual=x, alpha=self.alpha)


class RepBlock(nn.Module):
    """Stage of rep-style blocks: 'conv1' then 'block_0', 'block_1', ...
    n blocks in all; with block=BottleRep, n // 2 BottleReps of
    `basic_block` with weighted residuals (the CSP 'm' path)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 block=RepVGGBlock, basic_block=RepVGGBlock, deploy: bool = False):
        super().__init__()
        if block is BottleRep:
            make = functools.partial(BottleRep, block=basic_block, weight=True, deploy=deploy)
            n = n // 2
        else:
            make = functools.partial(block, deploy=deploy)
        self.conv1 = make(in_channels, out_channels)
        self.n = n
        for i in range(n - 1):
            self.add_module(f"block_{i}", make(out_channels, out_channels))

    def links(self):
        """The blocks in the order they run."""
        return [self.conv1] + [getattr(self, f"block_{i}") for i in range(self.n - 1)]

    def forward(self, x):
        for b in self.links():
            x = b(x)
        return x


class BepC3(nn.Module):
    """CSP block: 1x1 'cv1' -> RepBlock 'm' of BottleReps, concatenated with
    the 1x1 'cv2' branch, then 1x1 'cv3'. Its convs are SiLU exactly when
    the block is ConvWrapper, else ReLU."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1, e: float = 0.5,
                 concat: bool = True, block=RepVGGBlock, deploy: bool = False):
        super().__init__()
        c_ = int(out_channels * e)
        cba = functools.partial(ConvBNAct, act="silu" if block is ConvWrapper else "relu",
                                deploy=deploy)
        self.cv1 = cba(in_channels, c_, 1, 1)
        self.m = RepBlock(c_, c_, n=n, block=BottleRep, basic_block=block, deploy=deploy)
        self.concat = concat
        if concat:
            self.cv2 = cba(in_channels, c_, 1, 1)
        self.cv3 = cba(2 * c_ if concat else c_, out_channels, 1, 1)

    def forward(self, x):
        y1 = self.m(self.cv1(x))
        if self.concat:
            return self.cv3(torch.cat([y1, self.cv2(x)], 1))
        return self.cv3(y1)


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
        return conv_act(self.upsample_transpose, x, cuda_bias_act.NONE)


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


BLOCKS = {
    "repvgg": RepVGGBlock,
    "hyper_search": LinearAddBlock,
    "repopt": RealVGGBlock,
    "conv_relu": SimConvWrapper,
    "conv_silu": ConvWrapper,
}


def get_block(mode: str):
    """Training-mode block selector."""
    return BLOCKS[mode]
