"""Train-step decomposition profiler (counterpart of tools/profile_train.py):
where does a train step's time go?

Times each part of the step as its own program, K chained steps each, by
utils/profiler.timed_scan (CUDA events on the card):

  full       the train step (core/train_step.py: forward, assign, loss,
             backward, SGD, EMA) in bf16 (autocast, fp32 parameters)
  fwd        the train-mode forward alone, without gradient
  fwd_bwd    the forward and the gradient of sum(outputs) w.r.t. the
             parameters: the conv stack's forward and backward
  loss_fwd   assign + loss on fixed predictions
  loss_grad  assign + loss and its gradient w.r.t. the predictions
  opt        SGD + EMA on the parameters

and counts each part's flops (utils/profiler.model_flops: convolutions and
matmuls, 2 a multiply-add; one step). `unattributed_ms` is full minus
fwd_bwd, loss_grad and opt.

    python -m yololp_tpu_torch.tools.profile_train --device cuda
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import _leaves, model_flops, timed_scan


def fake_batch(rng, batch: int, img: int):
    """uint8 images and 1-3 plate labels an image (the JAX tool's batch)."""
    images = rng.integers(0, 255, (batch, img, img, 3), np.uint8)
    labels = np.zeros((batch, 16, 20), np.float32)
    labels[..., :8] = -1
    mask = np.zeros((batch, 16), np.float32)
    for b in range(batch):
        for k in range(1 + b % 3):
            labels[b, k, :8] = [1, 2, 3, 4, 5, 6, 7, 36]
            cx, cy = 0.2 + 0.3 * k, 0.3 + 0.2 * k
            labels[b, k, 8:12] = [cx, cy, 0.25, 0.1]
            labels[b, k, 12:20] = [cx - 0.12, cy - 0.04, cx - 0.12, cy + 0.04,
                                   cx + 0.12, cy + 0.04, cx + 0.12, cy - 0.04]
            mask[b, k] = 1
    return images, labels, mask


def _out_sum(tree) -> torch.Tensor:
    return sum(t.float().sum() for t in _leaves(tree))


def variants(model, state, train_step, loss_cfg, solver_cfg, images, labels, mask, k: int):
    """{name: (one_step(c), scan(images, c0))}: one step of each part, for
    the flop count, and its K-step chained program."""
    from yololp_tpu_torch.losses.loss import compute_loss
    from yololp_tpu_torch.models.effidehead import HeadTrainOutput
    from yololp_tpu_torch.ops.division import unit_pixels
    from yololp_tpu_torch.solver.build import ema_update, label_groups, schedule, sgd_apply

    dev = images.device
    params = state.params
    groups = [label_groups(model)[n] for n in state.names]

    def x_of(imgs, c):
        x = unit_pixels((imgs + c).permute(0, 3, 1, 2), torch.float32)
        return x.contiguous() if dev.type == "cpu" else x

    def fwd(x):
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            return model(x)

    with torch.no_grad():
        preds = fwd(x_of(images, 0))._replace(feats=None)
        preds = HeadTrainOutput(None, *(t.float() for t in preds[1:]))

    def perturbed(c: int):
        f = 1.0 + c * 1e-6
        return HeadTrainOutput(None, *(t * f for t in preds[1:]))

    def full_one(imgs, c):
        _, total, _ = train_step(state, imgs + c, labels, mask)
        return total

    def fwd_one(imgs, c):
        with torch.no_grad():
            return _out_sum(fwd(x_of(imgs, c))) * 1e-9

    def fwd_bwd_one(imgs, c):
        g = torch.autograd.grad(_out_sum(fwd(x_of(imgs, c))), params, allow_unused=True)
        return sum(t.sum() for t in g if t is not None) * 1e-9

    def loss_fwd_one(c):
        with torch.no_grad():
            return compute_loss(perturbed(c), labels, mask, loss_cfg)[0]

    def loss_grad_one(c):
        p = HeadTrainOutput(None, *(t.requires_grad_() for t in perturbed(c)[1:]))
        total, _ = compute_loss(p, labels, mask, loss_cfg)
        g = torch.autograd.grad(total, p[1:], allow_unused=True)
        return sum(t.sum() for t in g if t is not None) * 1e-9

    momentum = [m.clone() for m in state.momentum]
    pr = [p.detach().clone() for p in params]
    ema = [e.clone() for e in state.ema_params]

    @torch.no_grad()
    def opt_one(c: int):
        lr_w, lr_b, mom = schedule(solver_cfg, c)
        grads = torch._foreach_mul(pr, c * 1e-9)
        sgd_apply(pr, grads, momentum, groups, lr_w, lr_b, mom, solver_cfg.weight_decay)
        ema_update(ema, pr, 1 + c)
        return pr[0].sum() * 1e-9

    def chained(one, with_images=True):
        """K steps, each on its own input: the images offset by the step
        count (on the device), or the predictions scaled by it (a host int,
        so that no step reads the device)."""
        if with_images:
            def scan(imgs, c0):
                return sum(one(imgs, c0 + i) for i in range(k))
        else:
            def scan(_imgs, _c0):
                return sum(one(i) for i in range(k))
        return scan

    return {"full": (lambda c: full_one(images, c), chained(full_one)),
            "fwd": (lambda c: fwd_one(images, c), chained(fwd_one)),
            "fwd_bwd": (lambda c: fwd_bwd_one(images, c), chained(fwd_bwd_one)),
            "loss_fwd": (loss_fwd_one, chained(loss_fwd_one, False)),
            "loss_grad": (loss_grad_one, chained(loss_grad_one, False)),
            "opt": (opt_one, chained(opt_one, False))}


def main(argv=None):
    p = argparse.ArgumentParser("train-step decomposition profiler")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--iters", type=int, default=10, help="K chained steps per timed program")
    p.add_argument("--assigner", choices=["atss", "tal"], default="atss")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: batch 2, 64 px, 2 steps (overrides those flags)")
    args = p.parse_args(argv)
    if args.small:
        args.batch_size, args.img_size, args.iters = 2, 64, 2
    dev = resolve_device(args.device)

    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
    from yololp_tpu_torch.losses.loss import LossConfig
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.solver.build import SolverConfig
    from yololp_tpu_torch.utils.config import Config

    b, s, k = args.batch_size, args.img_size, args.iters
    cfg = (Config.fromfile(args.conf_file) if args.conf_file.endswith(".py")
           else Config.named(args.conf_file))
    model = build_model(cfg, seed=0, device=dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state = init_train_state(model)
    loss_cfg = LossConfig(img_size=(s, s), iou_type="giou", assigner=args.assigner)
    solver_cfg = SolverConfig(epochs=10, steps_per_epoch=100)
    train_step = make_train_step(model, loss_cfg, solver_cfg, batch_size=b, dtype=torch.bfloat16)
    images, labels, mask = (torch.from_numpy(a).to(dev)
                            for a in fake_batch(np.random.default_rng(2), b, s))
    model.train()

    out = {"platform": dev.type,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "batch": b, "img": s,
           "protocol": f"K={k} chained steps in one timed call (CUDA events on the card); "
                       "flops of one step by utils/profiler.model_flops"}
    c0 = torch.zeros((), dtype=torch.uint8, device=dev)
    for name, (one, scan) in variants(model, state, train_step, loss_cfg, solver_cfg, images,
                                      labels, mask, k).items():
        out[f"{name}_flops"] = model_flops(one, 3)["flops"]
        out[f"{name}_ms"] = timed_scan(scan, k, images, c0) * 1e3
    out["unattributed_ms"] = (out["full_ms"] - out["fwd_bwd_ms"] - out["loss_grad_ms"]
                              - out["opt_ms"])
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
