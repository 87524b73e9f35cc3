"""Knowledge distillation for the LP head (mirrors yololp_tpu/losses/distill.py).

Temperature-softened KL from teacher to student on the 8 classification
tasks (province, alphabet, 6 characters), each task's sigmoid scores
renormalized over its class axis, averaged over the foreground anchors; and,
where both heads carry reg_max bins, a KL on the DFL box distribution. The
weight ramps down over training as (1 + cos(pi * epoch / epochs)) / 2.

Held against the jitted JAX function: its divisions by a constant (`/ 8.0`,
the DFL logits' `/ temperature`) are reciprocal multiplies (ops/division.py);
the sums' denominators are traced values and stay true divisions. In a
process group the foreground count is the global batch's (summed over the
ranks), so each rank's terms are its share of the global ones. The
schedule is computed on the host in the jitted program's fp32 arithmetic,
as solver/build.py computes the lr cosine.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from yololp_tpu_torch.models.effidehead import HeadTrainOutput
from yololp_tpu_torch.ops.division import div_const
from yololp_tpu_torch.parallel.mesh import global_sum
from yololp_tpu_torch.solver.build import _F32, _rcp

_EPS = 1e-9


def _kl(p_teacher: torch.Tensor, p_student: torch.Tensor) -> torch.Tensor:
    """KL(teacher || student) over the last axis of probabilities, each
    renormalized to sum to one."""
    pt = p_teacher / (p_teacher.sum(-1, keepdim=True) + _EPS)
    ps = p_student / (p_student.sum(-1, keepdim=True) + _EPS)
    return (pt * (torch.log(pt + _EPS) - torch.log(ps + _EPS))).sum(-1)


def _temper(p: torch.Tensor, temperature: float) -> torch.Tensor:
    """p^(1/T) on p clipped to [eps, 1]; renormalized in _kl."""
    return torch.pow(torch.clamp(p, _EPS, 1.0), 1.0 / temperature)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's arithmetic: exp(x - max) divided by its sum (torch's
    softmax multiplies by the sum's reciprocal)."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def distill_loss(student: HeadTrainOutput, teacher: HeadTrainOutput, fg_mask: torch.Tensor,
                 temperature: float = 20.0, use_dfl: bool = False, reg_max: int = 0):
    """(cls_kd, dfl_kd) scalars averaged over the foreground anchors of
    `fg_mask` (B, A). The teacher's outputs carry no gradient."""
    fg = fg_mask.float()
    denom = torch.clamp(global_sum(fg.sum()), min=1.0)  # over the ranks' global batch
    t = lambda x: _temper(x.detach(), temperature)  # noqa: E731
    s = lambda x: _temper(x, temperature)  # noqa: E731

    kd = _kl(t(teacher.pro), s(student.pro))
    kd = kd + _kl(t(teacher.alp), s(student.alp))
    kd = kd + _kl(t(teacher.ads), s(student.ads)).sum(-1)  # the 6 character slots
    cls_kd = (div_const(kd, 8.0) * fg).sum() / denom * (temperature ** 2)

    if use_dfl and reg_max > 0:
        b, a, _ = student.reg.shape
        ps = _softmax(div_const(student.reg.reshape(b, a, 4, reg_max + 1), temperature))
        pt = _softmax(div_const(teacher.reg.detach().reshape(b, a, 4, reg_max + 1), temperature))
        dfl = div_const((pt * (torch.log(pt + _EPS) - torch.log(ps + _EPS))).sum(-1).sum(-1), 4.0)
        dfl_kd = (dfl * fg).sum() / denom * (temperature ** 2)
    else:
        dfl_kd = torch.zeros((), device=fg.device)
    return cls_kd, dfl_kd


def distill_weight_schedule(epoch, epochs: int) -> np.float32:
    """The distillation weight at a (fractional) epoch: (1 + cos(e * pi /
    epochs)) / 2 in fp32, with `e * pi / epochs` folded as jit folds it,
    e * fp32(pi * fp32(1 / epochs)), and the cosine rounded once from
    double (numpy's fp32 cos is off by an ulp where XLA's is not)."""
    e = _F32(epoch)
    arg = e * (_F32(math.pi) * _rcp(max(epochs, 1)))
    return (_F32(1.0) + _F32(math.cos(float(arg)))) * _F32(0.5)
