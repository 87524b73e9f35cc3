"""Plain PyTorch reference of the YOLOv6 P6 deploy forward in the conv_silu
mode (YOLOv6-L6: `CSPBepBackbone_P6` with fused P2, `CSPRepBiFPANNeck_P6`,
the 4-level LP EffiDeHead with DFL) and its 290-column decode, for the
P6 configurations under benchmark/configs/.

As reference/model.py does for the P5 graphs, it takes the unfused
(train-graph) state dict that the benchmark draws from the seed, folds every
BatchNorm itself (float64, then float32) and runs the deploy graph with plain
`torch.nn.functional` calls; it reuses that module's fold, conv providers,
roundings, ReLU conv units, BiFusion, SPPF, head maps and decode, and adds
the rest. Nothing here imports the program under test; the module names in
the keys are the state dict's interface.

The equations, YOLOv6's published P6 design (x the input of a unit, "unit"
the conv_silu block, a ConvWrapper: silu(conv3x3(x) + b), its conv bias and
BN folded into (W, b)):
- BottleRep: y = unit2(unit1(x)) + a * x when the channels match (every
  BottleRep of a BepC3 does), a the block's learnable `alpha` (YOLOv6's
  BepC3 builds its RepBlock of BottleReps with weight=True, so each has one).
- BepC3(c, n, e): c_ = int(c * e); cv3(cat(m(cv1(x)), cv2(x))), cv1, cv2 and
  cv3 1x1 SiLU convs, m n // 2 BottleReps (at least one) at c_ channels.
- Backbone: stem = unit(s2); then for ERBlock_2 .. ERBlock_6 a stride-2 unit
  and a BepC3; ERBlock_6 ends in an SPPF (1x1 to c/2, three chained 5x5
  max-pools, cat of the four, 1x1 to c); outputs P2 .. P6.
- Neck (its reduce layers, BiFusions and downsamples ReLU in every mode, its
  BepC3 stages the block's), top-down from P6: reduce_layer{j} (1x1 ReLU) of
  the deeper map, a BiFusion of it with the next two shallower backbone maps
  (a 2x transposed conv, a 1x1 ReLU of the same level, a 1x1 then 3x3
  stride-2 ReLU of the shallower one, cat, 1x1 ReLU), then a BepC3 stage:
  Rep_p5, Rep_p4, Rep_p3.
  Bottom-up: downsample{2-j} (3x3 stride-2 ReLU, channels kept), cat with the
  reduced map of that level, a BepC3 stage: Rep_n4, Rep_n5, Rep_n6. Outputs
  at strides 8, 16, 32, 64.
- Head, per level: a 1x1 SiLU stem, 3x3 SiLU cls and reg convs, 1x1 preds;
  the decode at strides (8, 16, 32, 64) with the DFL expectation over
  reg_max + 1 bins.

Departures from the published description, each as the repository's fork
builds the graph:
- The SPPF on P6 is ReLU (SimSPPF) whatever the block; the fork's P5
  backbones take the SiLU SPPF with ConvWrapper blocks.
- The conv_silu unit is the ConvWrapper of YOLOv6 v3.0: its conv has a bias
  before the BN.
- The LP head (277 class columns a level, 8 corner offsets beside the DFL
  bins) takes the place of COCO's 80 classes.
Any other backbone, neck, head or training mode raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import (Fused, bifusion, cba, decode, fp32_exact, head_maps,
                                       ncls_of, scaled_lists, sppf)

STRIDES = (8, 16, 32, 64)
CHUNK = 8  # images a reference forward takes at once at 1280: its activations stay small


def model_of(cfg) -> dict:
    """The model dict of a configuration this reference computes; raises on
    any other."""
    mc = cfg["model"]
    bb, nk, h = mc["backbone"], mc["neck"], mc["head"]
    if cfg.get("training_mode") != "conv_silu":
        raise ValueError(f"the P6 reference has no mode {cfg.get('training_mode')!r}")
    if bb["type"] != "CSPBepBackbone_P6" or not bb.get("fuse_P2") or bb.get("cspsppf"):
        raise ValueError(f"the P6 reference has no backbone {bb['type']} "
                         f"(fuse_P2 {bb.get('fuse_P2')}, cspsppf {bb.get('cspsppf')})")
    if nk["type"] != "CSPRepBiFPANNeck_P6":
        raise ValueError(f"the P6 reference has no neck {nk['type']}")
    if h["type"] != "EffiDeHead" or int(h["num_layers"]) != 4 or tuple(h["strides"]) != STRIDES:
        raise ValueError(f"the P6 reference has no head of {h['num_layers']} levels at "
                         f"strides {h['strides']}")
    return mc


def unit(P, x, p, cout, s=1):
    """The conv_silu block at `p`: silu(conv3x3(x) + b), folded from
    `<p>.block.conv` (biased) and `<p>.block.bn`."""
    return F.silu(P.conv(p + ".block", x, cout, 3, s))


def bottlerep(P, x, p, cout):
    y = unit(P, unit(P, x, p + ".conv1", cout), p + ".conv2", cout)
    return y + P.alpha(p) * x if x.shape[1] == cout else y


def bepc3(P, x, p, cout, n, e):
    c_ = int(cout * e)
    y = bottlerep(P, cba(P, x, p + ".cv1", c_, 1, act="silu"), p + ".m.conv1", c_)
    for i in range(n // 2 - 1):
        y = bottlerep(P, y, f"{p}.m.block_{i}", c_)
    y = torch.cat([y, cba(P, x, p + ".cv2", c_, 1, act="silu")], 1)
    return cba(P, y, p + ".cv3", cout, 1, act="silu")


def backbone(P, x, mc):
    """P2 .. P6 of `CSPBepBackbone_P6` with fused P2."""
    reps, ch = scaled_lists(mc)
    e = mc["backbone"]["csp_e"]
    x = unit(P, x, "backbone.stem", ch[0], 2)
    outs = []
    for i in range(5):
        st, c = f"backbone.ERBlock_{i + 2}", ch[i + 1]
        x = bepc3(P, unit(P, x, st + "_down", c, 2), st + "_csp", c, reps[i + 1], e)
        if i == 4:
            x = sppf(P, x, st + "_sppf", c)  # ReLU
        outs.append(x)
    return outs


def neck(P, xs, mc):
    """The 4 outputs (strides 8 .. 64) of `CSPRepBiFPANNeck_P6` on P2 .. P6."""
    reps, ch = scaled_lists(mc)
    e = mc["neck"]["csp_e"]
    xs = list(xs)[::-1]  # deepest first: P6 .. P2
    nb, k = 6, 3
    x, fpn = xs[0], []
    for j in range(k):
        c = ch[nb + j]
        f = cba(P, x, f"neck.reduce_layer{j}", c, 1)
        fpn.append(f)
        x = bepc3(P, bifusion(P, f, xs[j + 1], xs[j + 2], f"neck.Bifusion{j}", c),
                  f"neck.Rep_p{k + 2 - j}", c, reps[nb + j], e)
    outs = [x]
    for j in range(k):
        d = cba(P, x, f"neck.downsample{2 - j}", x.shape[1], 3, 2)
        x = bepc3(P, torch.cat([d, fpn[-1 - j]], 1), f"neck.Rep_n{k + 1 + j}", ch[nb + k + j],
                  reps[nb + k + j], e)
        outs.append(x)
    return outs


def forward(P, images_u8, cfg):
    """(N, H, W, 3) uint8 RGB -> the (N, A, 290) decode."""
    mc = model_of(cfg)
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    return decode(head_maps(P, neck(P, backbone(P, x, mc), mc), mc, ncls_of(cfg)), mc, STRIDES)


@torch.no_grad()
def decode_images(sd, cfg, images_u8, rounding=None):
    """The reference decode of uint8 RGB images (N, H, W, 3) on their device,
    CHUNK images at a time, fp32 with TF32 off; with `rounding` each conv's
    inputs and weights rounded to bf16 or fp8 (`Fused`)."""
    P = Fused(sd, rounding)
    out = []
    with fp32_exact():
        for i in range(0, images_u8.shape[0], CHUNK):
            out.append(forward(P, images_u8[i:i + CHUNK], cfg))
    return torch.cat(out)
