"""Seeded weights of a P6 configuration, made on the device: weights.py's
draw, then every BatchNorm calibrated on the P6 reference's own forward
(reference/p6.py) and the head's pred convs scaled on it.

The program's train-graph module is built on the meta device, given storage
on the card and filled from the seed with a generator on the card: one
normal and one uniform draw for the whole model, cut into the tensors (every
kernel He-style, std GAIN / sqrt(fan_in); BN scale and variance in [0.5,
1.5); BN shift and mean N(0, 0.1); every other parameter, the conv biases of
the conv_silu blocks and the BottleReps' alphas among them, its initial value
+ N(0, 0.1)).

Then one fp32 forward of the reference on CALIB_FRAMES seeded frames
(`Calibrate`) sets each BN's mean and variance to those of its conv's
output, and moves its shift up by BETA times its scale, so that every
activation's input is near N(BETA * scale, scale^2) per channel; and scales
each pred conv so that its logits (before the bias) spread by 1
(reference/model.py's `HeadScale`). Drawn statistics alone leave this graph
without its input: the conv_silu units shrink what the input adds at every
layer (silu'(0) = 1/2) while the drawn BN shifts add the same constants to
every image, so after the dozens of layers before each head level the
decode hardly depends on the frame (on yolov6l6 at 384 px, two frames'
boxes differ by 0.003 px at stride 8, against 0.03 px between the fp32 and
the bf16-rounded reference), and over a thousand anchors tie on one score.
Calibrated statistics with the shifts near zero go the other way: every
ReLU and SiLU layer then grows a small change of its input (by about 1.5x
and 1.2x in variance, for unit-normal inputs), and bf16 rounding grows
with the depth until it drowns the frame. With the shift at BETA = 2
scales the activations work near their linear side, where a normalised
layer passes a change on at about 1.015x; the decode then follows its frame
(at 384 px, boxes 10-55 px apart between two frames, against 0.2-2.9 px of
bf16 rounding and 3-35 px of fp8 rounding, by level).

The result is the unfused state dict that both the program and the
reference are handed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref
from benchmark.reference import p6
from benchmark.weights import CALIB_FRAMES, GAIN, _deterministic, port_config

BETA = 2.0  # each BN's shift after calibration, in units of its scale


class Calibrate(ref.HeadScale):
    """`HeadScale`, after setting each BN's statistics to those of its conv's
    output on this forward's own input and moving its shift by BETA times
    its scale. The calibrated statistics are written into the state dict."""

    def conv(self, prefix, x, cout, k, s=1):
        bn = prefix + ".bn"
        if bn + ".weight" in self.sd:
            u = F.conv2d(x, self.sd[prefix + ".conv.weight"], self.sd.get(prefix + ".conv.bias"),
                         s, k // 2)
            self.sd[bn + ".running_mean"].copy_(u.mean((0, 2, 3)))
            self.sd[bn + ".running_var"].copy_(u.var((0, 2, 3)))
            self.sd[bn + ".bias"].add_(BETA * self.sd[bn + ".weight"])
        return super().conv(prefix, x, cout, k, s)


@torch.no_grad()
def seeded_state_dict(cfg, seed: int, device) -> dict:
    from yololp_tpu_torch.models.yolo import Model

    p6.model_of(cfg)
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
        p6.forward(Calibrate(sd), frames, cfg)
    return sd
