"""Optimizer and LR/momentum schedules (mirrors yololp_tpu/solver/build.py).

Three parameter groups as in the reference's torch SGD: BN weights ('bnw',
no decay), conv weights ('w', weight decay), biases ('bias', no decay, their
own warmup lr). The per-epoch cosine with per-step linear warmup of lr and
momentum, and the accumulation count, are pure functions of the global step.

The JAX package computes the schedule inside its jitted train step; the
port computes it on the host, with the same fp32 arithmetic that program
runs (XLA's rewrites, held by tests/test_torch_solver.py): a division by a
constant is a multiply by its fp32 reciprocal (ops/division.py), a product
of constants is folded (`e * pi / epochs` is e * fp32(pi * fp32(1/epochs))),
`a + b * c` is one fused multiply-add, and a difference of two Python
constants is taken in double and then rounded. Only the cosine is not XLA's
own: numpy's fp32 cos can differ from it in the last bit. The host decides the step from Python
integers, so the train step reads nothing back from the card.

The SGD update and the EMA run as `torch._foreach_*` passes over the
parameter tensors of each group (a few kernels per pass, not a few per
tensor).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

_F32 = np.float32


class SolverConfig(NamedTuple):
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    lr_scheduler: str = "Cosine"
    epochs: int = 300
    steps_per_epoch: int = 1000


def _rcp(c) -> np.float32:
    """fp32(1 / fp32(c)): the reciprocal XLA multiplies by for `x / c`."""
    return _F32(1.0) / _F32(c)


def _fma(a, b, c) -> np.float32:
    """a * b + c rounded once to fp32 (XLA contracts it into an FMA). The
    product of two fp32 values is exact in double; the sum is rounded to
    double and then to fp32, which can differ from one rounding only on an
    exact tie of the two."""
    return _F32(float(a) * float(b) + float(c))


def lr_lambda(cfg: SolverConfig, epoch) -> np.float32:
    """Per-epoch multiplier, the epoch clamped to [0, epochs] (a resume with
    a shorter --epochs holds the terminal lrf instead of swinging the cosine
    past pi)."""
    if cfg.lr_scheduler == "Constant":
        return _F32(1.0)
    e = np.clip(_F32(epoch), _F32(0.0), _F32(cfg.epochs))
    arg = e * (_F32(math.pi) * _rcp(cfg.epochs))
    return _fma((_F32(1.0) - np.cos(arg)) * _F32(0.5), _F32(cfg.lrf - 1), _F32(1.0))


def warmup_steps(cfg: SolverConfig) -> int:
    return max(round(cfg.warmup_epochs * cfg.steps_per_epoch), 1000)


def _warm_frac(cfg: SolverConfig, step: int):
    s = _F32(step)
    wsteps = _F32(warmup_steps(cfg))
    return s, np.clip(s * _rcp(wsteps), _F32(0.0), _F32(1.0)), s <= wsteps


def schedule(cfg: SolverConfig, step: int):
    """(lr_weights, lr_bias, momentum) at a global step, as fp32 values. The
    cosine steps once per epoch, so within an epoch the target lr is
    lr0 * lr_lambda(epoch)."""
    s, frac, in_warm = _warm_frac(cfg, step)
    epoch = np.floor(s * _rcp(cfg.steps_per_epoch))
    base = _F32(cfg.lr0) * lr_lambda(cfg, epoch)
    if not in_warm:
        return base, base, _F32(cfg.momentum)
    wb = _F32(cfg.warmup_bias_lr)
    return (frac * base, _fma(frac, base - wb, wb),
            _fma(frac, _F32(cfg.momentum - cfg.warmup_momentum), _F32(cfg.warmup_momentum)))


def accumulate_steps(cfg: SolverConfig, batch_size: int, step: int) -> int:
    """Gradient-accumulation count: the nominal effective batch of 64,
    interpolated from 1 during warmup (round half to even)."""
    s, frac, in_warm = _warm_frac(cfg, step)
    if not in_warm:
        return int(max(1.0, round(64.0 / batch_size)))
    warm = np.round(_fma(frac, _F32(64.0 / batch_size - 1.0), _F32(1.0)))
    return int(max(warm, _F32(1.0)))


def ema_decay(updates: int) -> np.float32:
    """decay(u) = 0.9999 * (1 - exp(-u / 2000)), in fp32; exp is rounded
    correctly (XLA's own exp may differ from it by an ulp)."""
    x = -_F32(updates) * _rcp(2000.0)
    return _F32(0.9999) * (_F32(1.0) - _F32(math.exp(float(x))))


def param_group_label(key: str) -> str:
    """The group of the parameter at state dict `key`: 'bias' for every
    bias, 'bnw' for a BatchNorm's weight (flax's 'scale'; by the naming
    contract of layers/blocks.py a BN module's name ends in 'bn'), 'w',
    weight-decayed, for every other parameter: conv weights, a ScaleLayer's
    'weight' and a BottleRep's 'alpha' (the JAX function labels by leaf
    name, so those two are 'w' there too)."""
    module, _, leaf = key.rpartition(".")
    if leaf == "bias":
        return "bias"
    if leaf == "weight" and module.rpartition(".")[2].endswith("bn"):
        return "bnw"
    return "w"


def label_tree(params: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """{parameter name: `param_group_label`} over a name -> tensor map."""
    return {k: param_group_label(k) for k in params}


def label_groups(model: nn.Module) -> Dict[str, str]:
    """`label_tree` of the model's parameters."""
    return label_tree(dict(model.named_parameters()))


def init_momentum(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def sgd_apply(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              momentum_buf: Sequence[torch.Tensor], labels: Sequence[str],
              lr_w, lr_b, mom, weight_decay: float,
              grad_masks: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """Torch SGD with Nesterov momentum, in place on each group:
    d = g * mask (+ wd * p for 'w'); v = mom * v + d; p -= lr * (d + mom * v).
    grad_masks: RepOpt's per-weight masks, one per parameter (None where
    the mask is one)."""
    lr_w, lr_b, mom = float(lr_w), float(lr_b), float(mom)
    if grad_masks is not None:
        grads = [g if m is None else g * m for g, m in zip(grads, grad_masks)]
    for group in ("w", "bnw", "bias"):
        idx = [i for i, lab in enumerate(labels) if lab == group]
        if not idx:
            continue
        p = [params[i] for i in idx]
        v = [momentum_buf[i] for i in idx]
        d = torch._foreach_add([grads[i] for i in idx], p, alpha=weight_decay) \
            if group == "w" else [grads[i].clone() for i in idx]
        torch._foreach_mul_(v, mom)
        torch._foreach_add_(v, d)
        torch._foreach_add_(d, v, alpha=mom)
        torch._foreach_add_(p, d, alpha=-(lr_b if group == "bias" else lr_w))


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], new: Sequence[torch.Tensor], updates: int):
    """ema = d * ema + (1 - d) * new with d = ema_decay(updates), in place."""
    d = ema_decay(updates)
    torch._foreach_mul_(list(ema), float(d))
    torch._foreach_add_(list(ema), list(new), alpha=float(_F32(1.0) - d))
