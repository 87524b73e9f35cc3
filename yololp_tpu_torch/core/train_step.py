"""The training step: forward, loss, SGD, EMA and gradient accumulation
(mirrors yololp_tpu/core/train_step.py).

Reference behavior (yolov6/core/engine.py:137-166, 338-354): the forward
under autocast, the loss's backward summed into the gradients, an optimizer
step every `accumulate` micro-steps at the warmup-interpolated lr and
momentum, and an EMA update of the parameters and the BN statistics on each
optimizer step. Master parameters, gradients and optimizer state are fp32;
with compute dtype bf16 the forward runs under autocast(bfloat16), as the
JAX package's bf16 model computes in bf16 on fp32 parameters.

The JAX package jits one pure function of (TrainState, batch); here the
state is the model's own parameters and BN buffers plus the buffers below,
updated in place. Whether a micro-step steps the optimizer depends on host
integers only (`step`, `last_opt_step` and the accumulation count, in the
jitted program's fp32 arithmetic: solver/build.py), so a step reads nothing
back from the device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from yololp_tpu_torch.losses.loss import LossConfig, compute_loss
from yololp_tpu_torch.ops.division import unit_pixels
from yololp_tpu_torch.parallel.mesh import global_sum, world_size
from yololp_tpu_torch.solver.build import (_F32, SolverConfig, _rcp, accumulate_steps,
                                           ema_update, init_momentum, label_groups, schedule,
                                           sgd_apply)

_STATS = ("running_mean", "running_var")


class TrainState:
    """The model's fp32 parameters and BN statistics (the tensors
    themselves), the momentum buffers, the gradient buffers (the parameters'
    `.grad`, which backward sums into as torch does), the EMA copies, and
    the counts `ema_updates`, `step` and `last_opt_step` (host integers)."""

    def __init__(self, model: nn.Module):
        named = list(model.named_parameters())
        bad = [n for n, p in named if p.dtype != named[0][1].dtype
               or p.dtype not in (torch.float32, torch.float64)]
        if bad:
            raise TypeError(f"master parameters must be fp32 (float64 in tests): {bad[:3]}")
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        stats = [(n, b) for n, b in model.named_buffers() if n.endswith(_STATS)]
        self.stat_names: List[str] = [n for n, _ in stats]
        self.batch_stats: List[torch.Tensor] = [b for _, b in stats]
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.momentum = init_momentum(self.params)
        self.ema_params = [p.detach().clone() for p in self.params]
        self.ema_stats = [b.clone() for b in self.batch_stats]
        self.ema_updates = 0
        self.step = 0
        self.last_opt_step = -1_000_000

    @property
    def grad_accum(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and statistics by name."""
        return {**dict(zip(self.names, self.params)), **dict(zip(self.stat_names, self.batch_stats))}

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        return {**dict(zip(self.names, self.ema_params)),
                **dict(zip(self.stat_names, self.ema_stats))}

    @torch.no_grad()
    def load(self, variables: Dict[str, torch.Tensor], ema: Dict[str, torch.Tensor],
             momentum: Dict[str, torch.Tensor], ema_updates: int, step: int, last_opt_step: int):
        """Restore a state (resume): every tensor copied in place, gradients
        zeroed."""
        for dst, name in list(zip(self.params, self.names)) + list(zip(self.batch_stats, self.stat_names)):
            dst.copy_(variables[name])
        for dst, name in list(zip(self.ema_params, self.names)) + list(zip(self.ema_stats, self.stat_names)):
            dst.copy_(ema[name])
        for dst, name in zip(self.momentum, self.names):
            if name in momentum:
                dst.copy_(momentum[name])
            else:
                dst.zero_()
        torch._foreach_zero_(self.grad_accum)
        self.ema_updates, self.step, self.last_opt_step = int(ema_updates), int(step), int(last_opt_step)


def init_train_state(model: nn.Module) -> TrainState:
    return TrainState(model)


def _batch_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, dtype, non_blocking=True) if dtype else t.to(device, non_blocking=True)


class _RestoredStats:
    """Runs a model in train mode and puts its BN statistics back after: the
    teacher's forward normalizes with the batch's statistics, as the JAX
    step applies it (train=True, its batch_stats mutations discarded)."""

    def __init__(self, model: nn.Module):
        self.model = model

    def __enter__(self):
        self.saved = [b.clone() for b in self.model.buffers()]
        self.model.train()

    def __exit__(self, *exc):
        with torch.no_grad():
            for b, s in zip(self.model.buffers(), self.saved):
                b.copy_(s)


class TrainForward(nn.Module):
    """The train-mode forward of `model` in the compute dtype (bf16 under
    autocast), with QAT's fake-quantized weights and inputs when `quant_amax`
    is given: the module DistributedDataParallel wraps, so that every
    forward, QAT's too, runs through it."""

    def __init__(self, model: nn.Module, dtype: torch.dtype, quant_amax=None,
                 quant_skip=("proj_conv",)):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.quant_amax = quant_amax
        self.quant_skip = quant_skip

    def forward(self, x):
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            if self.quant_amax is None:
                return self.model(x)
            from yololp_tpu_torch.quant.quantize import quantize_weights, quantized_apply

            q = quantize_weights(self.model, skip_substrings=self.quant_skip, train=True)
            return quantized_apply(self.model, x, self.quant_amax,
                                   skip_substrings=self.quant_skip, train=True, weights=q)


def make_train_step(model: nn.Module, loss_cfg: LossConfig, solver_cfg: SolverConfig,
                    batch_size: int, quant_amax=None, quant_skip=("proj_conv",),
                    grad_masks=None, teacher=None, distill_cfg=None,
                    dtype: torch.dtype = torch.float32):
    """train_step(state, images_u8, gt_labels, gt_mask) -> (state, total,
    items). images: (B, H, W, 3) uint8; labels (B, M, 20) and mask (B, M);
    numpy or tensors, moved to the model's device. dtype: the compute dtype
    (bf16 runs the forward under autocast; float64, for a float64 model, is
    the tests' exact reference). quant_amax: {conv path: amax}
    turns on QAT (conv inputs and kernels fake-quantized, straight-through
    gradient). grad_masks: RepOpt's {parameter name: mask}
    (solver/repopt.py:gradient_masks), applied to the summed gradient before
    weight decay. teacher: a train-graph model of the same head layout;
    with it the loss adds the LP distillation terms (losses/distill.py)
    weighted by distill_cfg {'class', 'dfl', 'temperature'} and by the
    cosine ramp-down at the step's epoch. `state` is the TrainState of
    `model`, updated in place. `batch_size` is the global batch: the
    accumulation follows it.

    In a process group of more than one rank each rank passes its shard of
    the global batch and the step computes the global batch's update: the
    forward runs through DistributedDataParallel (which averages the
    gradients), each rank's loss is its share of the global loss (losses/)
    times the world size, BN normalizes by the global batch's statistics,
    and the returned total and items are the global ones. SGD, the EMA,
    RepOpt's masks and QAT then run alike on every rank."""
    if dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"compute dtype {dtype}: fp32 or bf16 (float64 for a float64 model)")
    names = [n for n, _ in model.named_parameters()]
    labels = [label_groups(model)[n] for n in names]
    masks = None
    if grad_masks is not None:
        unknown = set(grad_masks) - set(names)
        if unknown:
            raise KeyError(f"gradient masks for no parameter: {sorted(unknown)[:3]}")
        masks = [grad_masks.get(n) for n in names]
    device = next(model.parameters()).device
    wd = solver_cfg.weight_decay
    dcfg = dict(distill_cfg or {})
    if teacher is not None:
        from yololp_tpu_torch.losses.distill import distill_loss, distill_weight_schedule

        teacher.requires_grad_(False)

    world = world_size()
    net = TrainForward(model, dtype, quant_amax, quant_skip)
    if world > 1:
        # DDP broadcasts rank 0's parameters and buffers here and averages
        # the gradients of the ranks' losses, which are scaled by the world
        # size below
        from torch.nn.parallel import DistributedDataParallel

        net = DistributedDataParallel(net)

    def loss(x, out, gt_labels, gt_mask, step: int):
        if teacher is None:
            return compute_loss(out, gt_labels, gt_mask, loss_cfg)
        total, items, fg = compute_loss(out, gt_labels, gt_mask, loss_cfg, with_fg=True)
        with torch.no_grad(), _RestoredStats(teacher), torch.autocast(
                device.type, dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
            t_out = teacher(x)
        cls_kd, dfl_kd = distill_loss(out, t_out, fg,
                                      temperature=float(dcfg.get("temperature", 20.0)),
                                      use_dfl=loss_cfg.use_dfl, reg_max=loss_cfg.reg_max)
        # the epoch as the jitted program computes it: step * fp32(1 / steps)
        epoch = _F32(step) * _rcp(max(solver_cfg.steps_per_epoch, 1))
        kd_w = float(distill_weight_schedule(epoch, solver_cfg.epochs))
        return total + kd_w * (float(dcfg.get("class", 1.0)) * cls_kd
                               + float(dcfg.get("dfl", 1.0)) * dfl_kd), items

    def train_step(state: TrainState, images, gt_labels, gt_mask):
        model.train()
        x = unit_pixels(_batch_tensor(images, device).permute(0, 3, 1, 2), dtype)
        if device.type == "cpu":
            # a channels_last backward through the train graph at 640 px
            # corrupts the heap in the CPU build of torch 2.13
            x = x.contiguous()
        step = state.step
        opt_step = step - state.last_opt_step >= accumulate_steps(solver_cfg, batch_size, step)
        # a micro-step that does not step the optimizer keeps its gradient
        # on this rank; DDP sums the ranks' accumulated gradients on the next
        # optimizer step (the same update as a sync on every micro-step)
        with (net.no_sync() if world > 1 and not opt_step else contextlib.nullcontext()):
            total, items = loss(x, net(x), _batch_tensor(gt_labels, device, torch.float32),
                                _batch_tensor(gt_mask, device, torch.float32), step)
            (total * world if world > 1 else total).backward()
        if world > 1:
            # the logged loss is the global batch's: the sum of the ranks' shares
            both = global_sum(torch.cat([total.detach().view(1), items]))
            total, items = both[0], both[1:]

        if opt_step:
            lr_w, lr_b, mom = schedule(solver_cfg, step)
            sgd_apply(state.params, state.grad_accum, state.momentum, labels, lr_w, lr_b, mom, wd,
                      grad_masks=masks)
            state.ema_updates += 1
            ema_update(state.ema_params, state.params, state.ema_updates)
            ema_update(state.ema_stats, state.batch_stats, state.ema_updates)
            torch._foreach_zero_(state.grad_accum)
            state.last_opt_step = step
        state.step = step + 1
        return state, total.detach(), items

    return train_step
