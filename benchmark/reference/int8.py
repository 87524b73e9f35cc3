"""Plain reference of the true-int8 deployment (the `conv` plan) of the
YOLO-LP / YOLOv6 P5 RepVGG graph (EfficientRep backbone, RepBiFPAN or
RepPAN neck, the LP head), in plain `torch`, for the configurations under
benchmark/configs/ that carry an `int8` block.

It follows the plan's published description (the port's quantization
notes, which are YOLOv6's TensorRT int8 deployment: per-tensor activation
scales from max calibration, per-channel weight scales, requantizing
handoffs between single-consumer ReLU layers):

- Max calibration: each conv's (and transposed conv's) input amax over the
  calibration frames, on the float model's own forward (`calibrate`). The
  3-channel stem and the DFL projection are skipped (`SKIP`).
- Weights: each conv unit folded in fp32, as the deployment folds it
  (`folded`: BN into its conv; a RepVGG block's three branches into one
  3x3), then per output channel scale = max(max|w|, 1e-9) / qmax, codes
  round_half_even(w / scale) clipped to [-qmax - 1, qmax].
- Activations: per tensor, s = fp32(amax) / qmax; codes
  clip(round_half_even(x * fp32(1 / s)), -qmax - 1, qmax): a division by a
  constant as jitted JAX computes it, a multiply by its fp32 reciprocal.
- The conv: int8 x int8 summed exactly, as a float64 conv (every partial
  sum an integer below 2**53), CHUNK images at a time.
- The epilogue, as the JAX package's `_conv_kernel` defines it: y =
  fp32(acc) * a + b, the multiply and the add each rounded in fp32. It
  dequantizes (a = s * w_scale, b = bias; the layer's activation follows)
  or requantizes to the consumer's scale s' (a = s * w_scale / s', b =
  bias / s', both rounded in fp32 in that order), the ReLU folded into the
  clip: codes clip(round_half_even(y), 0, qmax).
- The plan (`plan`). A deploy RepBlock whose every link is calibrated is a
  chain: each link requantizes to the next link's scale, the last
  dequantizes (ReLU) unless its exit hands off. A single-consumer ReLU
  producer hands its codes to its consumer: each backbone stage's down conv
  to its RepBlock's first link; the SPPF's (or CSP-SPPF's) internal seams
  and its exit to the neck's reduce_layer0 (max-pooling and concatenation
  keep codes codes); each BiFusion's cv2 to its downsample; and the chain
  exits Rep_p4 -> reduce_layer1, Rep_n4 -> the deepest head stem, and
  ERBlock_5's RepBlock -> a plain SPPF's cv1 (a CSP-SPPF's cv1 and cv2
  share that input). Transposed convs and skipped convs stay float.
- The float layers in the served precision: with `rounding` "bf16" every
  float tensor that the deployment holds in bf16 is rounded to bf16 (each
  conv's input, a float conv's weights and bias, its sum before and after
  the bias, a dequantized output), and computed in fp32 in between. With
  `rounding` None everything float is fp32.

A handed-off tensor is carried as codes * s' in float64, which max-pooling,
concatenation and the ReLU after the producer leave exact, and which its
consumer divides back into the same codes.

Departures, noted: the entry's /255 is a multiply by fp32(1/255), as the
jitted program divides by a constant (in bf16 the two agree on every
pixel value); a float conv's bias is added after the conv's sum has been
rounded to the served precision, as the deployment's separate epilogue
adds it. Nothing here imports the program under test; the module names in
the state dict's keys are its interface.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref

QMAX = 127
SKIP = ("proj_conv", "backbone/stem")
TRANSPOSE = "upsample_transpose"
STAGES = ("ERBlock_2", "ERBlock_3", "ERBlock_4", "ERBlock_5")
RECIP_255 = float(torch.tensor(1.0) / torch.tensor(255.0))


def path_of(prefix: str) -> str:
    """The module path (the amax table's key) of the conv of the unit at
    `prefix`: a conv unit's deploy conv is `<prefix>/conv`; a head pred conv
    and a transposed conv are the module itself."""
    p = prefix.replace(".", "/")
    return p if ("_pred" in prefix or prefix.endswith(TRANSPOSE)) else p + "/conv"


def skipped(path: str, skip=SKIP) -> bool:
    return any(s in path for s in skip)


def int8_unit(prefix: str, amax, skip=SKIP) -> bool:
    """Whether the unit at `prefix` runs in int8: calibrated, not skipped,
    not a transposed conv."""
    path = path_of(prefix)
    return path in amax and not skipped(path, skip) and not prefix.endswith(TRANSPOSE)


def plan(cfg, amax, skip=SKIP) -> dict:
    """The handoffs {producer prefix: consumer prefix} of the `conv` plan on
    the configuration's graph, for the calibrated convs of `amax`: a chain's
    links hand off to the next link."""
    mc = cfg["model"]
    bb, nk = mc["backbone"], mc["neck"]
    if (bb["type"] != "EfficientRep" or nk["type"] not in ("RepBiFPANNeck", "RepPANNeck")
            or cfg.get("training_mode", "repvgg") != "repvgg"):
        raise ValueError("the int8 reference takes the P5 RepVGG graph (EfficientRep, "
                         f"RepPAN / RepBiFPAN), not {bb['type']} / {nk['type']}")
    reps, _ = ref.scaled_lists(mc)
    handoffs = {}

    def ok(*prefixes):
        return all(int8_unit(p, amax, skip) for p in prefixes)

    def hand(prod, cons):
        if ok(prod, cons):
            handoffs[prod] = cons

    def chain(p, n):
        """The last link of RepBlock `p` where it is a chain, else None."""
        links = [p + ".conv1"] + [f"{p}.block_{i}" for i in range(n - 1)]
        if not ok(*links):
            return None
        handoffs.update(zip(links[:-1], links[1:]))
        return links[-1]

    last = {}
    for i, st in enumerate(STAGES):
        last[st] = chain(f"backbone.{st}_rep", reps[i + 1])
        hand(f"backbone.{st}_down", f"backbone.{st}_rep.conv1")
    sp, red0 = "backbone.ERBlock_5_sppf", "neck.reduce_layer0"
    if bb.get("cspsppf"):
        for a, b in (("cv1", "cv3"), ("cv3", "cv4"), ("cv4", "cv5"), ("cv5", "cv6"),
                     ("cv6", "cv7"), ("cv2", "cv7")):
            hand(f"{sp}.{a}", f"{sp}.{b}")
        hand(f"{sp}.cv7", red0)
    else:
        hand(f"{sp}.cv1", f"{sp}.cv2")
        hand(f"{sp}.cv2", red0)
        if last["ERBlock_5"] is not None:
            hand(last["ERBlock_5"], f"{sp}.cv1")
    if "BiFPAN" in nk["type"]:
        for j in range(2):
            hand(f"neck.Bifusion{j}.cv2", f"neck.Bifusion{j}.downsample")
    exits = {}
    for j, name in enumerate(("Rep_p4", "Rep_p3", "Rep_n3", "Rep_n4")):
        exits[name] = chain(f"neck.{name}", reps[5 + j])
    for name, cons in (("Rep_p4", "neck.reduce_layer1"), ("Rep_n4", "detect.stem2")):
        if exits[name] is not None:
            hand(exits[name], cons)
    return handoffs


def host_scale(amax: float, qmax: int) -> torch.Tensor:
    """fp32(amax) / qmax, a true division in fp32 on the host."""
    return torch.tensor(float(amax), dtype=torch.float32) / float(qmax)


def weight_codes(w: torch.Tensor, qmax: int):
    """(codes, scale) of an fp32 kernel (O, C, k, k) per output channel, on
    the host in fp32."""
    w = w.detach().cpu().float()
    scale = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-9) / float(qmax)
    codes = torch.round(w / scale[:, None, None, None]).clamp(-qmax - 1, qmax)
    return codes, scale


def _bn32(sd, p, w):
    """A BN at `p` folded into kernel `w` in fp32: t = gamma / sqrt(var +
    eps), (w * t, (0 - mean) * t + beta)."""
    t = sd[p + ".weight"].float() / torch.sqrt(sd[p + ".running_var"].float() + ref.BN_EPS)
    return w.float() * t[:, None, None, None], (0.0 - sd[p + ".running_mean"].float()) * t + \
        sd[p + ".bias"].float()


def folded(sd, prefix):
    """(weight, bias) in fp32 of the unit at `prefix`, folded in fp32 as the
    deployment folds it (a conv and its BN; a RepVGG block's 3x3, then its
    padded 1x1, then its identity, weights and biases summed in that
    order), or from an already folded deploy state dict (its
    `<prefix>.conv` as it is). A plain biased conv is taken as it is."""
    if prefix + ".rbr_dense_conv.weight" in sd:
        w, b = _bn32(sd, prefix + ".rbr_dense_bn", sd[prefix + ".rbr_dense_conv.weight"])
        w1, b1 = _bn32(sd, prefix + ".rbr_1x1_bn", sd[prefix + ".rbr_1x1_conv.weight"])
        w, b = w + F.pad(w1, (1, 1, 1, 1)), b + b1
        if prefix + ".rbr_identity_bn.weight" in sd:
            eye = torch.zeros_like(w)
            idx = torch.arange(w.shape[0], device=w.device)
            eye[idx, idx, 1, 1] = 1.0
            wi, bi = _bn32(sd, prefix + ".rbr_identity_bn", eye)
            w, b = w + wi, b + bi
        return w, b
    if prefix + ".bn.weight" in sd:
        assert prefix + ".conv.bias" not in sd, prefix
        return _bn32(sd, prefix + ".bn", sd[prefix + ".conv.weight"])
    if prefix + ".conv.weight" in sd:
        return sd[prefix + ".conv.weight"].float(), sd[prefix + ".conv.bias"].float()
    return sd[prefix + ".weight"].float(), sd[prefix + ".bias"].float()


def _id(t):
    return t


class Int8:
    """The int8 plan as a provider of reference/model.py's layer functions.
    `qmax` 127 is int8; a smaller one (31: 6-bit codes) quantizes every
    int8 conv one precision below. `codes`, when a dict, receives each
    int8 conv's input codes by module path."""

    def __init__(self, sd, cfg, amax, qmax: int = QMAX, rounding="bf16", skip=SKIP,
                 codes=None):
        self.sd, self.amax, self.qmax, self.skip, self.codes = sd, amax, qmax, skip, codes
        self.r = ref.ROUNDINGS[rounding] or _id
        self.handoffs = plan(cfg, amax, skip)
        self.fed = set(self.handoffs.values())  # consumers whose input arrives as codes
        self._w = {}

    def _int8_weights(self, prefix, device):
        if prefix not in self._w:
            w, b = folded(self.sd, prefix)
            codes, w_scale = weight_codes(w, self.qmax)
            self._w[prefix] = (codes.double().to(device), w_scale, b.cpu())
        return self._w[prefix]

    def scale(self, prefix) -> torch.Tensor:
        return host_scale(self.amax[path_of(prefix)], self.qmax)

    def quantize(self, x, s):
        inv = float(torch.tensor(1.0) / s)
        return torch.round(x.float() * inv).clamp(-self.qmax - 1, self.qmax)

    def conv(self, prefix, x, cout, k, s=1):
        if not int8_unit(prefix, self.amax, self.skip):
            w, b = folded(self.sd, prefix)
            r = self.r
            y = r(F.conv2d(r(x.float()), r(w.float().to(x.device)), None, s, k // 2))
            return r(y + r(b.float().to(x.device))[None, :, None, None])
        codes_w, w_scale, bias = self._int8_weights(prefix, x.device)
        assert codes_w.shape == (cout, x.shape[1], k, k), (prefix, tuple(codes_w.shape))
        s_in = self.scale(prefix)
        if prefix in self.fed:  # codes * s_in in float64: divided back exactly
            q = torch.round(x.double() / float(s_in))
        else:
            q = self.quantize(self.r(x.float()), s_in)
        if self.codes is not None:
            self.codes.setdefault(path_of(prefix), []).append(q.to(torch.int8).cpu())
        acc = F.conv2d(q.double(), codes_w, None, s, k // 2).float()
        dev = x.device
        if prefix in self.handoffs:
            s_next = self.scale(self.handoffs[prefix])
            a, b = s_in * w_scale / s_next, bias / s_next
            y = acc * a.to(dev)[None, :, None, None]
            y = y + b.to(dev)[None, :, None, None]
            return torch.round(y).clamp(0, self.qmax).double() * float(s_next)
        y = acc * (s_in * w_scale).to(dev)[None, :, None, None]
        return self.r(y + bias.to(dev)[None, :, None, None])

    def convt(self, prefix, x, cout):
        r = self.r
        w = r(self.sd[prefix + ".weight"].float().to(x.device))
        y = r(F.conv_transpose2d(r(x.float()), w, None, stride=2))
        return r(y + r(self.sd[prefix + ".bias"].float().to(x.device))[None, :, None, None])


def forward(P, images_u8, cfg):
    """(N, H, W, 3) uint8 RGB -> the (N, A, 290) decode through provider P."""
    x = images_u8.permute(0, 3, 1, 2).float() * RECIP_255
    mc = cfg["model"]
    return ref.decode(ref.head_maps(P, ref.neck(P, ref.backbone(P, x, mc), mc), mc,
                                    ref.ncls_of(cfg)), mc)


@torch.no_grad()
def decode_images(sd, cfg, images_u8, amax, qmax: int = QMAX, rounding="bf16", codes=None):
    """The int8 plan's decode of uint8 RGB images (N, H, W, 3) on their
    device, CHUNK images at a time, with TF32 off, on the calibration
    `amax` ({module path: amax}, the program's own where the check gives
    it)."""
    P = Int8(sd, cfg, amax, qmax, rounding, codes=codes)
    with ref.fp32_exact():
        out = [forward(P, images_u8[i:i + ref.CHUNK], cfg)
               for i in range(0, images_u8.shape[0], ref.CHUNK)]
    return torch.cat(out)


class Observe(ref.Fused):
    """The float forward (reference/model.py's `Fused`, with its rounding,
    on `folded` weights), noting each unskipped conv's and transposed conv's
    input amax."""

    def __init__(self, sd, rounding=None, skip=SKIP):
        super().__init__(sd, rounding)
        self.skip, self.amax = skip, {}

    def _weights(self, prefix, dtype):
        if prefix not in self._w:
            w, b = folded(self.sd, prefix)
            self._w[prefix] = (w.to(dtype), b.to(dtype))
        return self._w[prefix]

    def _see(self, prefix, x):
        path = path_of(prefix)
        if not skipped(path, self.skip):
            seen = (self.round(x) if self.round else x).abs().amax()
            self.amax[path] = max(self.amax.get(path, 0.0), float(seen))

    def conv(self, prefix, x, cout, k, s=1):
        self._see(prefix, x)
        return super().conv(prefix, x, cout, k, s)

    def convt(self, prefix, x, cout):
        self._see(prefix, x)
        return super().convt(prefix, x, cout)


@torch.no_grad()
def calibrate(sd, cfg, batches, rounding="bf16", skip=SKIP) -> dict:
    """Max calibration: {module path: the largest |input| of that conv over
    the uint8 `batches`}, on the float forward with each conv's inputs and
    weights in `rounding` ("bf16": as the deployment calibrates its bf16
    model), TF32 off."""
    P = Observe(sd, rounding, skip)
    with ref.fp32_exact():
        for b in batches:
            for i in range(0, b.shape[0], ref.CHUNK):
                ref.forward(P, b[i:i + ref.CHUNK], cfg["model"], ref.ncls_of(cfg))
    return P.amax
