"""Seeded weights of a configuration, made on the device.

The program's train-graph module (`yololp_tpu_torch.models.yolo.Model`) is
built on the meta device, given storage on the card and filled from the
seed with a generator on the card: one normal and one uniform draw for the
whole model, cut into the tensors. The recipe is chip_smoke.py's
`randomize_parameters`: every kernel He-style (std gain / sqrt(fan_in)), BN
scale and variance in [0.5, 1.5), BN shift and mean N(0, 0.1), every other
parameter its initial value + N(0, 0.1). So the head's scores vary and the
NMS sees real candidates (the plain init scores every anchor at the 0.01
prior). Then each pred conv of the head is scaled so that its logits
(before the bias) spread by 1 on a batch of seeded frames
(reference/model.py's `HeadScale`, the reference's own forward): the deep
CSP stacks of yolov6m grow their activations level by level, and without
it every class score and DFL bin saturates. (Setting every BN's statistics
to its input's instead makes the random network chaotic: bf16 rounding then
grows layer by layer until the outputs decorrelate from fp32.) The result
is the unfused state dict that both the program and the reference are
handed.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import model as ref

GAIN = 0.7
CALIB_FRAMES = 4


def port_config(cfg):
    """The program's Config for a benchmark configuration file."""
    from yololp_tpu_torch.utils.config import Config

    return Config({"model": cfg["model"], "training_mode": cfg["training_mode"]})


@torch.no_grad()
def seeded_state_dict(cfg, seed: int, device) -> dict:
    from yololp_tpu_torch.models.yolo import Model

    vocab = cfg["vocab"]
    with torch.device("meta"):
        model = Model(port_config(cfg), npro=vocab["npro"], nalp=vocab["nalp"], nads=vocab["nads"])
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    normal, uniform = [], []  # (tensor, std, base) and (tensor, low)
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            normal.append((w, GAIN / fan_in ** 0.5, 0.0))
            if m.bias is not None:
                base = 0.0
                if ".cls_pred" in "." + name:
                    base = -torch.log(torch.tensor((1 - 1e-2) / 1e-2)).item()
                elif ".reg_pred" in "." + name:
                    base = 1.0
                normal.append((m.bias, 0.1, base))
        elif isinstance(m, torch.nn.BatchNorm2d):
            uniform += [(m.weight, 0.5), (m.running_var, 0.5)]
            normal += [(m.bias, 0.1, 0.0), (m.running_mean, 0.1, 0.0)]
            m.num_batches_tracked.zero_()
        else:
            for pname, p in m.named_parameters(recurse=False):
                base = getattr(m, "scale_init", 1.0) if pname == "weight" else (
                    1.0 if pname == "alpha" else 0.0)
                normal.append((p, 0.1, base))

    n = torch.randn(sum(t.numel() for t, _, _ in normal), generator=gen, device=device)
    for (t, std, base), chunk in zip(normal, n.split([t.numel() for t, _, _ in normal])):
        t.copy_(chunk.view_as(t) * std + base)
    u = torch.rand(sum(t.numel() for t, _ in uniform), generator=gen, device=device)
    for (t, low), chunk in zip(uniform, u.split([t.numel() for t, _ in uniform])):
        t.copy_(chunk.view_as(t) + low)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    size = int(cfg["img_size"])
    frames = torch.randint(0, 256, (CALIB_FRAMES, size, size, 3), dtype=torch.uint8,
                           generator=gen, device=device)
    with ref.fp32_exact(), _deterministic():
        ref.forward(ref.HeadScale(sd), frames, cfg["model"], ref.ncls_of(cfg))
    return sd


@contextlib.contextmanager
def _deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
