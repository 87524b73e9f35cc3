"""int8 calibration and fake-quant simulation, with QAT's straight-through
gradient (mirrors yololp_tpu/quant/quantize.py).

The JAX package observes conv inputs with a flax `intercept_methods` pass;
here forward pre-hooks on every `nn.Conv2d` / `nn.ConvTranspose2d` do the
same. Module paths are the JAX ones, joined with '/' (the port's module tree
carries the JAX names), so an amax json written by either package loads
unchanged into the other. Skip lists match by substring.

The amax reducers (`merge_calib_stats`, `_amax_percentile`, `_amax_entropy`,
`_amax_mse`, `compute_amax`) are plain numpy, copied so that the port imports
nothing of the JAX package.

Which functions carry a gradient:
  * `fake_quant_ste` is `fake_quant` with the JAX package's custom VJP
    (`_fq_bwd`): the gradient passes where |x| <= max(amax, 1e-9) and is zero
    outside; amax gets none.
  * `quantize_weights(..., train=True)` returns the live conv weights
    fake-quantized through `fake_quant_ste` (a {parameter name: tensor} dict
    in the graph, amax traced per output channel), and
    `quantized_apply(..., train=True, weights=...)` runs the model with them
    (`torch.func.functional_call`) and its conv inputs fake-quantized through
    `fake_quant_ste`: the QAT train step's forward (core/train_step.py).
  * Inference only: `fake_quant`, `quantize_weights(train=False)` (a
    fake-quantized deep copy, no gradient), `quantized_apply(train=False)`
    (under inference mode) and the calibration functions.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yololp_tpu_torch.ops.division import div_const, unit_pixels
from yololp_tpu_torch.utils.device import resolve_device

HIST_BINS = 2048

# layers never quantized: the DFL projection and the 3-channel stem (the
# JAX package's list, quant/quantize.py:32-39)
DEFAULT_SKIP_SUBSTRINGS: Tuple[str, ...] = ("proj_conv", "backbone/stem")

QUANTIZABLE = (nn.Conv2d, nn.ConvTranspose2d)


def _skip(path: str, skip_substrings: Sequence[str]) -> bool:
    return any(s in path for s in skip_substrings)


def module_path(name: str) -> str:
    """torch's dotted module name -> the JAX module path."""
    return name.replace(".", "/")


def quantizable_modules(model: nn.Module):
    """(JAX path, module) of every conv and transposed conv of `model`."""
    return [(module_path(n), m) for n, m in model.named_modules() if isinstance(m, QUANTIZABLE)]


def fake_quant(x: torch.Tensor, amax, num_bits: int = 8) -> torch.Tensor:
    """round_half_even(clip(x / scale, -qmax - 1, qmax)) * scale with
    scale = max(amax, 1e-9) / qmax, in the dtype of `x` (forward only).

    As the JAX package's jitted programs compute it (ops/division.py): a
    Python-number `amax` is a trace-time constant there (quantized_apply's
    calibrated amax), so the scale is a true division folded on the host and
    `x / scale` a multiply by its reciprocal; a tensor `amax` is traced
    (quantize_weights' per-channel amax), so `/ qmax` is a multiply by
    fp32(1/qmax) and `x / scale` a true division."""
    qmax = 2.0 ** (num_bits - 1) - 1.0
    if isinstance(amax, (int, float)):
        scale = float(torch.tensor(max(float(amax), 1e-9), dtype=torch.float32) / qmax)
        return torch.round(torch.clamp(div_const(x, scale), -qmax - 1, qmax)) * scale
    amax = torch.as_tensor(amax, dtype=x.dtype, device=x.device)
    scale = div_const(torch.clamp(amax, min=1e-9), qmax)
    return torch.round(torch.clamp(x / scale, -qmax - 1, qmax)) * scale


class _FakeQuantSTE(torch.autograd.Function):
    """fake_quant forward, straight-through backward inside the clip range."""

    @staticmethod
    def forward(ctx, x, amax, num_bits):
        if isinstance(amax, torch.Tensor):
            bound = torch.clamp(amax.detach().to(torch.float32), min=1e-9)
        else:  # fp32, as the JAX package's jnp.maximum(amax, 1e-9) of an fp32 amax
            bound = torch.tensor(max(float(np.float32(amax)), float(np.float32(1e-9))),
                                 dtype=torch.float32)
        ctx.save_for_backward(x, bound.to(x.device))
        return fake_quant(x, amax, num_bits)

    @staticmethod
    def backward(ctx, g):
        x, bound = ctx.saved_tensors
        return g * (x.abs() <= bound).to(g.dtype), None, None


def fake_quant_ste(x: torch.Tensor, amax, num_bits: int = 8) -> torch.Tensor:
    """`fake_quant` whose gradient w.r.t. `x` is `g * (|x| <= max(amax,
    1e-9))` (the JAX package's `_fq_bwd`), with no gradient to `amax`."""
    return _FakeQuantSTE.apply(x, amax, num_bits)


# ---------------- calibration ----------------


def _image_tensor(images_u8, device, dtype) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> NCHW (channels_last) in [0, 1], as the inferer."""
    x = images_u8 if isinstance(images_u8, torch.Tensor) else torch.as_tensor(np.asarray(images_u8))
    return unit_pixels(x.to(device).permute(0, 3, 1, 2), dtype)


def model_device_dtype(model: nn.Module):
    """(device, float dtype) of `model`'s parameters."""
    p = next(p for p in model.parameters() if p.is_floating_point())
    return p.device, p.dtype


def check_model_device(model: nn.Module, device) -> torch.device:
    """`device` resolved (raising without a card unless it is the CPU), and
    the model required to lie on it."""
    dev = resolve_device(device)
    model_dev = model_device_dtype(model)[0]
    if model_dev.type != dev.type or (dev.index is not None and model_dev.index != dev.index):
        raise ValueError(f"the model lies on {model_dev}, the caller asked for {dev}")
    return dev


def histogram(a: torch.Tensor, amax: float) -> torch.Tensor:
    """Counts of |values| `a` (fp32) in HIST_BINS linear bins on [0, amax],
    the last bin open-ended; the bin index `a / width` is a reciprocal
    multiply, as the jitted JAX calibrator computes it (width is constant)."""
    width = max(amax, 1e-12) / HIST_BINS
    idx = torch.clamp(div_const(a, width).to(torch.int32), 0, HIST_BINS - 1)
    return torch.bincount(idx.reshape(-1).long(), minlength=HIST_BINS).double()


def make_calib_fn(model: nn.Module, mode: str = "max",
                  skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
                  amax_by_path: Dict[str, float] | None = None):
    """fn(images_u8) -> {path: stat} over one batch, stats on the host.

    mode 'max': per-conv input amax. mode 'histogram': per-conv |x|
    histogram over HIST_BINS linear bins on [0, amax_by_path[path]] (bins
    fixed by a prior max pass, so that batches merge by summing)."""
    if mode == "histogram" and not amax_by_path:
        raise ValueError("histogram mode needs amax_by_path from a prior "
                         "max-mode calibration pass (two-pass binning)")
    device, dtype = model_device_dtype(model)
    targets = [(p, m) for p, m in quantizable_modules(model)
               if not _skip(p, skip_substrings)]

    def observer(path):
        def hook(_module, args):
            a = args[0].float().abs()
            if mode == "max":
                captured[path] = a.amax()
            elif path in amax_by_path:
                captured[path] = histogram(a, amax_by_path[path])
        return hook

    captured: Dict[str, torch.Tensor] = {}

    @torch.inference_mode()
    def calib(images_u8):
        captured.clear()
        handles = [m.register_forward_pre_hook(observer(p)) for p, m in targets]
        try:
            model(_image_tensor(images_u8, device, dtype).contiguous(
                memory_format=torch.channels_last))
        finally:
            for h in handles:
                h.remove()
        return {k: v.cpu().numpy() for k, v in captured.items()}

    return calib


def merge_calib_stats(per_batch: List[Dict], mode: str = "max") -> Dict:
    """Reduce per-batch stats: max over batches, or summed histograms."""
    merged = {}
    for stats in per_batch:
        for k, v in stats.items():
            if mode == "max":
                merged[k] = max(merged.get(k, 0.0), float(v))
            else:
                hist = np.asarray(v, np.float64)
                merged[k] = merged[k] + hist if k in merged else hist
    return merged


def _amax_percentile(hist: np.ndarray, edges: np.ndarray, percentile: float) -> float:
    """The right edge of the bin where the cdf first reaches `percentile`."""
    total = hist.sum()
    if total <= 0:
        return float(edges[-1])
    cdf = np.cumsum(hist) / total
    idx = int(np.searchsorted(cdf, percentile / 100.0))
    return float(edges[min(idx + 1, len(edges) - 1)])


def _amax_entropy(hist: np.ndarray, edges: np.ndarray, num_bits: int = 8,
                  stride: int = 1, start_bin: int = 128) -> float:
    """TensorRT-style KL-divergence amax search; the last argmin wins."""
    bins = hist.astype(np.float64).copy()
    if len(bins) < start_bin + 1:
        return float(edges[-1])
    bins[0] = bins[1]
    nlevels = 1 << (num_bits - 1)
    divergences = []
    for i in range(start_bin, len(bins) + 1, stride):
        space = np.linspace(0, i, num=nlevels + 1)
        digitized = np.digitize(np.arange(i), space) - 1
        digitized = np.where(bins[:i] == 0, -1, digitized)
        counts = np.zeros(nlevels)
        occup = np.zeros(nlevels)
        valid = digitized >= 0
        np.add.at(counts, digitized[valid], bins[:i][valid])
        np.add.at(occup, digitized[valid], 1.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            density_per_level = np.where(occup > 0, counts / occup, 0.0)
        q = np.where(valid, density_per_level[np.clip(digitized, 0, None)], 0.0)
        q_total = q.sum() + bins[i:].sum()
        p = bins[:i].copy()
        p[-1] += bins[i:].sum()
        p_total = p.sum()
        if q_total <= 0 or p_total <= 0:
            divergences.append(np.inf)
            continue
        p /= p_total
        q /= q_total
        mask = (p > 0) & (q > 0)
        kl = np.sum(p[mask] * np.log(p[mask] / q[mask]))
        if np.any((p > 0) & (q <= 0)):
            kl = np.inf
        divergences.append(kl)
    div = np.asarray(divergences)
    last_argmin = len(div) - 1 - int(np.argmin(div[::-1]))
    return float(edges[min(last_argmin * stride + start_bin, len(edges) - 1)])


def _amax_mse(hist: np.ndarray, edges: np.ndarray, num_bits: int = 8,
              stride: int = 1, start_bin: int = 128) -> float:
    """The bin-center amax minimising sum(hist * fake-quant error**2)."""
    centers = (edges[:-1] + edges[1:]) / 2.0
    qmax = 2.0 ** (num_bits - 1) - 1.0
    best_amax, best_err = float(edges[-1]), np.inf
    for i in range(start_bin, len(centers), stride):
        amax = centers[i]
        scale = amax / qmax
        q = np.clip(np.round(centers / scale), -qmax - 1, qmax) * scale
        err = float((hist * (centers - q) ** 2).sum())
        if err < best_err:
            best_err, best_amax = err, float(amax)
    return best_amax


def compute_amax(stats: Dict, method: str = "max", percentile: float = 99.99,
                 amax_by_path: Dict[str, float] | None = None,
                 num_bits: int = 8) -> Dict[str, float]:
    """Histogram -> amax by max, percentile, entropy or mse."""
    if method == "max":
        return {k: float(v) for k, v in stats.items()}
    out = {}
    for k, hist in stats.items():
        top = max(amax_by_path[k], 1e-12)
        edges = np.linspace(0.0, top, HIST_BINS + 1)
        hist = np.asarray(hist, np.float64)
        if method == "percentile":
            out[k] = _amax_percentile(hist, edges, percentile)
        elif method == "entropy":
            out[k] = _amax_entropy(hist, edges, num_bits=num_bits)
        elif method == "mse":
            out[k] = _amax_mse(hist, edges, num_bits=num_bits)
        else:
            raise ValueError(method)
    return out


def calibrate(model: nn.Module, batches: Iterable, method: str = "max",
              percentile: float = 99.99,
              skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
              device="cuda") -> Dict[str, float]:
    """PTQ calibration: run uint8 NHWC `batches` through `model` (which must
    lie on `device`) and return each conv input's amax by `method`.
    Histogram methods take two passes: max, then fixed-bin histograms."""
    check_model_device(model, device)
    batches = list(batches)
    calib_fn = make_calib_fn(model, mode="max", skip_substrings=skip_substrings)
    global_amax = merge_calib_stats([calib_fn(b) for b in batches], mode="max")
    if method == "max":
        return global_amax
    hist_fn = make_calib_fn(model, mode="histogram", skip_substrings=skip_substrings,
                            amax_by_path=global_amax)
    merged = merge_calib_stats([hist_fn(b) for b in batches], mode="histogram")
    return compute_amax(merged, method=method, percentile=percentile,
                        amax_by_path=global_amax)


# ---------------- fake-quant simulation ----------------


def _out_channel_dims(m: nn.Module) -> Tuple[int, ...]:
    """Reduction dims of a per-output-channel amax: OIHW for a conv,
    (in, out, kH, kW) for a transposed conv."""
    return (0, 2, 3) if isinstance(m, nn.ConvTranspose2d) else (1, 2, 3)


def quantize_weights(model: nn.Module, num_bits: int = 8,
                     skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
                     train: bool = False):
    """Every conv kernel of `model` fake-quantized per output channel, in
    fp32 (the JAX package's quantize_weights), the amax max|w| of each
    channel. train=False: a copy of `model` holding them (no gradient).
    train=True: {parameter name: fake-quantized weight} of the live weights,
    through the straight-through `fake_quant_ste`, for `quantized_apply`."""
    if not train:
        return _quantized_copy(model, num_bits, skip_substrings)
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, QUANTIZABLE) and not _skip(module_path(name), skip_substrings):
            w = m.weight.float()
            amax = w.detach().abs().amax(dim=_out_channel_dims(m), keepdim=True)
            out[f"{name}.weight"] = fake_quant_ste(w, amax, num_bits).to(m.weight.dtype)
    return out


@torch.no_grad()
def _quantized_copy(model: nn.Module, num_bits: int, skip_substrings: Sequence[str]) -> nn.Module:
    out = copy.deepcopy(model)
    for path, m in quantizable_modules(out):
        if _skip(path, skip_substrings):
            continue
        w = m.weight.float()
        dims = _out_channel_dims(m)
        amax = w.abs().amax(dim=dims, keepdim=True)
        m.weight.copy_(fake_quant(w, amax, num_bits).to(m.weight.dtype))
    return out


def quantized_apply(model: nn.Module, x: torch.Tensor, amax_by_path: Dict[str, float],
                    num_bits: int = 8,
                    skip_substrings: Sequence[str] = DEFAULT_SKIP_SUBSTRINGS,
                    train: bool = False, weights: Dict[str, torch.Tensor] | None = None):
    """Forward with each calibrated conv's input fake-quantized (in fp32,
    then cast back). train=False runs under inference mode; train=True keeps
    the graph, the inputs going through `fake_quant_ste`, and `weights`
    (from quantize_weights(train=True)) replace the module's own."""
    fq = fake_quant_ste if train else fake_quant

    def hook_for(path):
        def hook(_module, args):
            a0 = fq(args[0].float(), float(amax_by_path[path]), num_bits)
            return (a0.to(args[0].dtype),) + tuple(args[1:])
        return hook

    handles = [m.register_forward_pre_hook(hook_for(p)) for p, m in quantizable_modules(model)
               if p in amax_by_path and not _skip(p, skip_substrings)]
    try:
        with contextlib.nullcontext() if train else torch.inference_mode():
            if weights:
                return torch.func.functional_call(model, weights, (x,), strict=False)
            return model(x)
    finally:
        for h in handles:
            h.remove()


def save_amax(amax: Dict[str, float], path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(amax, f, indent=1)


def load_amax(path: str) -> Dict[str, float]:
    with open(path) as f:
        return json.load(f)
