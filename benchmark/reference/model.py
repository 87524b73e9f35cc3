"""Plain PyTorch reference of the YOLO-LP / YOLOv6 deploy forward and its
290-column decode, for the configurations under benchmark/configs/.

It takes the unfused (train-graph) state dict that the benchmark draws from
the seed, folds every BatchNorm and RepVGG block itself (in float64, then
float32), and runs the deploy graph with plain `torch.nn.functional` calls:
EfficientRep or CSPBep backbones (P5, optional fused P2, SPPF or CSPSPPF),
RepPAN / RepBiFPAN necks and their CSP (BepC3 / BottleRep) variants, and the
3-level LP EffiDeHead with or without DFL. Nothing here imports the program
under test; the module names in the keys are the state dict's interface.

The layer functions take a provider `P` that supplies each conv: `Fused`
computes it from the folded weights (optionally with inputs and weights
rounded to bf16, the served precision, or to fp8 e4m3, the control one
precision below it), and
flops/model.py passes one that counts operations on the meta device.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
FP8_MAX = 448.0  # largest finite float8_e4m3fn
CHUNK = 16  # images a reference forward takes at once: its activations stay small


def make_divisible(x, divisor=8):
    return int(math.ceil(x / divisor) * divisor)


def scaled_lists(model_cfg):
    """(repeats, channels) after the depth and width multipliers."""
    d, w = model_cfg["depth_multiple"], model_cfg["width_multiple"]
    bb, nk = model_cfg["backbone"], model_cfg["neck"]
    reps = [(max(round(i * d), 1) if i > 1 else i)
            for i in list(bb["num_repeats"]) + list(nk["num_repeats"])]
    chans = [make_divisible(i * w, 8) for i in list(bb["out_channels"]) + list(nk["out_channels"])]
    return reps, chans


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN convs and matmuls while the reference runs; the
    flags are put back after, so the program under test keeps its own."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """`t` through bfloat16."""
    return t.to(torch.bfloat16).to(t.dtype)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` through float8 e4m3 with one per-tensor scale (amax to 448)."""
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _bn_scale_shift(sd, p):
    t = sd[p + ".weight"].double() / torch.sqrt(sd[p + ".running_var"].double() + BN_EPS)
    return t, sd[p + ".bias"].double() - sd[p + ".running_mean"].double() * t


def fold(sd, prefix):
    """(weight, bias) in float64 of the conv unit at `prefix`: a RepVGG
    block (3x3, 1x1 and identity branches with their BNs), a conv with its
    BN, or a plain biased conv."""
    if prefix + ".rbr_dense_conv.weight" in sd:
        w3 = sd[prefix + ".rbr_dense_conv.weight"].double()
        t3, b3 = _bn_scale_shift(sd, prefix + ".rbr_dense_bn")
        w1 = sd[prefix + ".rbr_1x1_conv.weight"].double()
        t1, b1 = _bn_scale_shift(sd, prefix + ".rbr_1x1_bn")
        w = w3 * t3[:, None, None, None] + F.pad(w1 * t1[:, None, None, None], (1, 1, 1, 1))
        b = b3 + b1
        if prefix + ".rbr_identity_bn.weight" in sd:
            ti, bi = _bn_scale_shift(sd, prefix + ".rbr_identity_bn")
            idx = torch.arange(w.shape[0], device=w.device)
            w[idx, idx, 1, 1] += ti
            b = b + bi
        return w, b
    if prefix + ".bn.weight" in sd:
        w = sd[prefix + ".conv.weight"].double()
        t, shift = _bn_scale_shift(sd, prefix + ".bn")
        b0 = sd.get(prefix + ".conv.bias")
        b = shift if b0 is None else shift + b0.double() * t
        return w * t[:, None, None, None], b
    return sd[prefix + ".weight"].double(), sd[prefix + ".bias"].double()


ROUNDINGS = {None: None, "bf16": bf16_round, "fp8": fp8_round}


class Fused:
    """Convs from the folded fp32 weights of an unfused state dict. With
    `rounding` "bf16" or "fp8" each conv's input and weight go through
    `bf16_round` (the served precision) or `fp8_round` (the control one
    precision below it), accumulating in fp32."""

    def __init__(self, sd, rounding=None):
        self.sd, self.round, self._w = sd, ROUNDINGS[rounding], {}

    def _weights(self, prefix, dtype):
        if prefix not in self._w:
            w, b = fold(self.sd, prefix)
            self._w[prefix] = (w.to(dtype), b.to(dtype))
        return self._w[prefix]

    def conv(self, prefix, x, cout, k, s=1):
        w, b = self._weights(prefix, x.dtype)
        assert w.shape == (cout, x.shape[1], k, k), (prefix, tuple(w.shape))
        if self.round:
            x, w = self.round(x), self.round(w)
        return F.conv2d(x, w, b, s, k // 2)

    def convt(self, prefix, x, cout):
        w = self.sd[prefix + ".weight"].to(x.dtype)
        b = self.sd[prefix + ".bias"].to(x.dtype)
        if self.round:
            x, w = self.round(x), self.round(w)
        return F.conv_transpose2d(x, w, b, stride=2)

    def alpha(self, prefix):
        return self.sd[prefix + ".alpha"].float()


class HeadScale(Fused):
    """`Fused`, after scaling each pred conv's kernel of the head so that
    its logits (before the bias) have the spread `target` on this forward's
    own input. The scaled kernels are written into the state dict."""

    def __init__(self, sd, target: float = 1.0):
        super().__init__(sd)
        self.target = target

    def conv(self, prefix, x, cout, k, s=1):
        if prefix.startswith("detect.") and "_pred" in prefix:
            w = self.sd[prefix + ".weight"]
            w.mul_(self.target / F.conv2d(x, w, None, s, k // 2).std())
        return super().conv(prefix, x, cout, k, s)


_ACT = {"relu": F.relu, "silu": F.silu}


def cba(P, x, p, cout, k, s=1, act="relu"):
    return _ACT[act](P.conv(p, x, cout, k, s))


def repvgg(P, x, p, cout, s=1):
    return F.relu(P.conv(p, x, cout, 3, s))


def bottlerep(P, x, p, cout):
    y = repvgg(P, repvgg(P, x, p + ".conv1", cout), p + ".conv2", cout)
    return y + P.alpha(p) * x if x.shape[1] == cout else y


def repblock(P, x, p, cout, n, bottle=False):
    unit = bottlerep if bottle else repvgg
    n = n // 2 if bottle else n
    x = unit(P, x, p + ".conv1", cout)
    for i in range(n - 1):
        x = unit(P, x, f"{p}.block_{i}", cout)
    return x


def bepc3(P, x, p, cout, n, e):
    c_ = int(cout * e)
    y1 = repblock(P, cba(P, x, p + ".cv1", c_, 1), p + ".m", c_, n, bottle=True)
    return cba(P, torch.cat([y1, cba(P, x, p + ".cv2", c_, 1)], 1), p + ".cv3", cout, 1)


def _pool3(x):
    y1 = F.max_pool2d(x, 5, 1, 2)
    y2 = F.max_pool2d(y1, 5, 1, 2)
    return [x, y1, y2, F.max_pool2d(y2, 5, 1, 2)]


def sppf(P, x, p, cout):
    x = cba(P, x, p + ".cv1", x.shape[1] // 2, 1)
    return cba(P, torch.cat(_pool3(x), 1), p + ".cv2", cout, 1)


def cspsppf(P, x, p, cout):
    c_ = int(cout * 0.5)
    x1 = cba(P, cba(P, cba(P, x, p + ".cv1", c_, 1), p + ".cv3", c_, 3), p + ".cv4", c_, 1)
    y0 = cba(P, x, p + ".cv2", c_, 1)
    m = cba(P, cba(P, torch.cat(_pool3(x1), 1), p + ".cv5", c_, 1), p + ".cv6", c_, 3)
    return cba(P, torch.cat([y0, m], 1), p + ".cv7", cout, 1)


def backbone(P, x, mc):
    reps, ch = scaled_lists(mc)
    bb = mc["backbone"]
    if bb["type"] not in ("EfficientRep", "CSPBepBackbone"):
        raise ValueError(f"the reference has no backbone {bb['type']}")
    csp = bb["type"] == "CSPBepBackbone"
    x = repvgg(P, x, "backbone.stem", ch[0], 2)
    outs = []
    stages = ["ERBlock_2", "ERBlock_3", "ERBlock_4", "ERBlock_5"]
    for i, st in enumerate(stages):
        c = ch[i + 1]
        x = repvgg(P, x, f"backbone.{st}_down", c, 2)
        if csp:
            x = bepc3(P, x, f"backbone.{st}_csp", c, reps[i + 1], bb["csp_e"])
        else:
            x = repblock(P, x, f"backbone.{st}_rep", c, reps[i + 1])
        if st == stages[-1]:
            x = (cspsppf if bb.get("cspsppf") else sppf)(P, x, f"backbone.{st}_sppf", c)
        if st != "ERBlock_2" or bb.get("fuse_P2"):
            outs.append(x)
    return outs


def bifusion(P, deep, same, shallow, p, c):
    x0 = P.convt(p + ".upsample.upsample_transpose", deep, c)
    x1 = cba(P, same, p + ".cv1", c, 1)
    x2 = cba(P, cba(P, shallow, p + ".cv2", c, 1), p + ".downsample", c, 3, 2)
    return cba(P, torch.cat([x0, x1, x2], 1), p + ".cv3", c, 1)


def neck(P, xs, mc):
    reps, ch = scaled_lists(mc)
    nk = mc["neck"]
    if nk["type"] not in ("RepPANNeck", "RepBiFPANNeck", "CSPRepPANNeck", "CSPRepBiFPANNeck"):
        raise ValueError(f"the reference has no neck {nk['type']}")
    bif = "BiFPAN" in nk["type"]
    csp_e = nk.get("csp_e") if nk["type"].startswith("CSP") else None

    def stage(x, p, c, n):
        return bepc3(P, x, p, c, n, csp_e) if csp_e else repblock(P, x, p, c, n)

    xs = list(xs)[::-1]
    nb, k = 5, 2
    x, fpn = xs[0], []
    for j in range(k):
        c = ch[nb + j]
        f = cba(P, x, f"neck.reduce_layer{j}", c, 1)
        fpn.append(f)
        if bif:
            merged = bifusion(P, f, xs[j + 1], xs[j + 2], f"neck.Bifusion{j}", c)
        else:
            merged = torch.cat([P.convt(f"neck.upsample{j}.upsample_transpose", f, c), xs[j + 1]], 1)
        x = stage(merged, f"neck.Rep_p{k + 2 - j}", c, reps[nb + j])
    outs = [x]
    for j in range(k):
        c_down, c_out = ch[nb + k + 2 * j], ch[nb + k + 2 * j + 1]
        d = cba(P, x, f"neck.downsample{2 - j}", c_down, 3, 2)
        x = stage(torch.cat([d, fpn[-1 - j]], 1), f"neck.Rep_n{k + 1 + j}", c_out, reps[nb + k + j])
        outs.append(x)
    return outs


def head_maps(P, xs, mc, ncls):
    """Per level (cls logits, reg+corner map), NCHW."""
    h = mc["head"]
    nreg = 4 * (int(h["reg_max"]) + 1)
    maps = []
    for i, x in enumerate(xs):
        c = x.shape[1]
        stem = cba(P, x, f"detect.stem{i}", c, 1, act="silu")
        cls = P.conv(f"detect.cls_pred{i}", cba(P, stem, f"detect.cls_conv{i}", c, 3, act="silu"),
                     ncls, 1)
        reg = P.conv(f"detect.reg_pred{i}", cba(P, stem, f"detect.reg_conv{i}", c, 3, act="silu"),
                     nreg + 8, 1)
        maps.append((cls, reg))
    return maps


def decode(maps, mc, strides=(8, 16, 32)):
    """(B, A, 290): [xywh, obj = 1, 4 corners, sigmoided class scores],
    anchors level by level, each row-major; computed in fp32 (or float64)."""
    h = mc["head"]
    reg_max, dfl = int(h["reg_max"]), bool(h["use_dfl"])
    nreg = 4 * (reg_max + 1)
    dt = torch.promote_types(maps[0][0].dtype, torch.float32)
    b = maps[0][0].shape[0]
    cls, reg, cor, pts, st = [], [], [], [], []
    for (c, r), s in zip(maps, strides):
        hh, ww = c.shape[2], c.shape[3]
        cls.append(c.permute(0, 2, 3, 1).reshape(b, hh * ww, -1))
        r = r.permute(0, 2, 3, 1).reshape(b, hh * ww, -1)
        reg.append(r[..., :nreg])
        cor.append(r[..., nreg:])
        gy, gx = torch.meshgrid(torch.arange(hh, dtype=dt, device=c.device) + 0.5,
                                torch.arange(ww, dtype=dt, device=c.device) + 0.5, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        st.append(torch.full((hh * ww, 1), float(s), dtype=dt, device=c.device))
    scores = torch.sigmoid(torch.cat(cls, 1).to(dt))
    reg, cor = torch.cat(reg, 1).to(dt), torch.cat(cor, 1).to(dt)
    a, stride = torch.cat(pts), torch.cat(st)
    if dfl:
        prob = torch.softmax(reg.reshape(b, -1, 4, reg_max + 1), -1)
        reg = (prob * torch.arange(reg_max + 1, dtype=dt, device=reg.device)).sum(-1)
    x1y1, x2y2 = a - reg[..., :2], a + reg[..., 2:4]
    box = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * stride
    ax, ay = a[:, :1], a[:, 1:]
    quad = torch.cat([a - cor[..., 0:2],
                      ax - cor[..., 2:3], ay + cor[..., 3:4],
                      a + cor[..., 4:6],
                      ax + cor[..., 6:7], ay - cor[..., 7:8]], -1) * stride
    return torch.cat([box, torch.ones_like(box[..., :1]), quad, scores], -1)


def forward(P, images_u8, mc, ncls):
    """(N, H, W, 3) uint8 RGB -> the (N, A, 290) decode."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    return decode(head_maps(P, neck(P, backbone(P, x, mc), mc), mc, ncls), mc)


def ncls_of(cfg):
    v = cfg["vocab"]
    return v["npro"] + v["nalp"] + 6 * v["nads"]


@torch.no_grad()
def decode_images(sd, cfg, images_u8, rounding=None):
    """The reference decode of uint8 RGB images (N, H, W, 3) on their device,
    CHUNK images at a time, fp32 with TF32 off; with `rounding` each conv's
    inputs and weights rounded to bf16 or fp8 (`Fused`)."""
    P = Fused(sd, rounding)
    out = []
    with fp32_exact():
        for i in range(0, images_u8.shape[0], CHUNK):
            out.append(forward(P, images_u8[i:i + CHUNK], cfg["model"], ncls_of(cfg)))
    return torch.cat(out)
