"""int8 convolution with a fused per-out-channel epilogue: the CUDA kernel
csrc/int8_conv.cu and its plain PyTorch version.

Counterpart of yololp_tpu/ops/pallas_conv.py. `int8_conv` calls the custom
op `yololp_torch::int8_conv` (ops/library.py), which runs the kernel on a
CUDA tensor and the plain version on a CPU tensor; on a CUDA tensor it
launches the kernel or raises. `_build.launches("int8_conv")` counts the
kernel's launches.

Layouts are the kernel's: activations NHWC, weights (O, KH, KW, C), one
contiguous reduction vector per output channel. KH = KW in {1, 3}, stride in
{1, 2}, padding KH // 2 on every side (the port's convs). The kernel reads
the weights through a TMA tensor map, built once per weight tensor and kept
in `_WEIGHT_MAPS` (with a reference to the tensor, so that its memory is
not reused while the map points at it).

While spans record (utils/profiler.py), each call of `int8_conv` adds 1 to
the counter `int8.convs`, and each float -> code quantize (`quantize_codes`)
is the span `int8.quantize`, adds its elements to `int8.quantized` and 1 to
`int8.quantize_fused` (the quantizes that took the op of
ops/cuda_quantize.py).

Epilogue (per output channel o): y = acc * a[o] + b[o] as a multiply and an
add rounded separately, then int8 `clip(round_half_even(y), 0 if relu else
-128, 127)`, or a float `relu(y)` in fp32 or bf16, or (out_dtype int32) the
accumulator itself.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from yololp_tpu_torch.ops import _build
from yololp_tpu_torch.ops.cuda_matmul import rows16
from yololp_tpu_torch.ops.division import reciprocal
from yololp_tpu_torch.utils import profiler

_LAUNCH = _build.Kernel("int8_conv", "int8_conv_launch",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9,
                        failure="error {} (a cudaError_t, or 9999 / 10000 + CUresult from the "
                                "tensor-map encoder)")
_WEIGHT_MAP = _build.Entry("int8_conv", "int8_conv_weight_map",
                           [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_void_p])
_PLAN = _build.Entry("int8_conv", "int8_conv_plan", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                     restype=None)

# (address, shape, version, device) of a weight tensor -> (the tensor, the
# rows the map reads, the map's 128 bytes); the oldest dropped past the cap
_WEIGHT_MAPS: "OrderedDict[tuple, tuple]" = OrderedDict()
_WEIGHT_MAPS_CAP = 256

_MODES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2, torch.int32: 3}
_MODE_DTYPES = list(_MODES)


def out_mode(out_dtype: torch.dtype) -> int:
    """The kernel's number for an output dtype (the op's `out_mode`)."""
    if out_dtype not in _MODES:
        raise TypeError(f"out_dtype {out_dtype} is not one of {_MODE_DTYPES}")
    return _MODES[out_dtype]


def mode_dtype(mode: int) -> torch.dtype:
    """The output dtype of the kernel's mode number `mode`."""
    if not 0 <= mode < len(_MODE_DTYPES):
        raise TypeError(f"out_mode {mode} is not one of 0..{len(_MODE_DTYPES) - 1} "
                        f"({_MODE_DTYPES})")
    return _MODE_DTYPES[mode]


def out_size(h: int, kh: int, stride: int) -> int:
    return (h + 2 * (kh // 2) - kh) // stride + 1


def int8_conv_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The exact int32 accumulator (N, Ho, Wo, O) of x_q (N, H, W, C) int8 and
    w_q (O, KH, KW, C) int8. The conv runs in fp64, where every partial sum
    is an integer below 2**53 and so exact in any order (fp32 is not:
    |acc| reaches 9 * C * 128**2 > 2**24)."""
    kh = w_q.shape[1]
    y = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.permute(0, 3, 1, 2).double(),
                 stride=stride, padding=kh // 2)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def epilogue_plain(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, relu: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's epilogue on an int32 accumulator (..., O), in fp32."""
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * a.float()
    y = y + b.float()
    if out_dtype == torch.int8:
        return torch.round(y).clamp(0.0 if relu else -128.0, 127.0).to(torch.int8)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def int8_conv_plain(x_q, w_q, a, b, stride: int = 1, relu: bool = True,
                    out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Plain PyTorch version of the kernel: exact accumulator, then the same
    epilogue. Returns (N, Ho, Wo, O) contiguous."""
    return epilogue_plain(int8_conv_acc_plain(x_q, w_q, stride), a, b, relu, out_dtype)


def _check(x_q, w_q, a, b, stride, relu, out_dtype):
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"x_q must be (N, H, W, C) and w_q (O, KH, KW, C), got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    o, kh, kw, c = w_q.shape
    if kh != kw or kh not in (1, 3):
        raise ValueError(f"kernel {kh}x{kw}: only 1x1 and 3x3 are supported")
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}: only 1 and 2 are supported")
    if x_q.shape[-1] != c:
        raise ValueError(f"x_q has {x_q.shape[-1]} channels, w_q {c}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype}, {w_q.dtype}")
    if a.shape != (o,) or b.shape != (o,) or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a and b must be float32 of shape ({o},)")
    if out_dtype not in _MODES:
        raise TypeError(f"out_dtype {out_dtype} is not one of {list(_MODES)}")
    devs = {t.device for t in (x_q, w_q, a, b)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def int8_conv_cuda(x_q, w_q, a, b, stride: int = 1, relu: bool = True,
                   out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Launch csrc/int8_conv.cu on CUDA tensors; raise on any refusal."""
    _check(x_q, w_q, a, b, stride, relu, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {x_q.device}")
    if not all(t.is_contiguous() for t in (x_q, w_q, a, b)):
        raise ValueError("x_q, w_q, a and b must be contiguous (x_q NHWC)")
    n, h, w, c = x_q.shape
    o, kh = w_q.shape[:2]
    ho, wo = out_size(h, kh, stride), out_size(w, kh, stride)
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    _LAUNCH.launch(x_q.device, x_q.data_ptr(), weight_map(w_q), a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), n, h, w, c, o, kh, stride, _MODES[out_dtype], int(relu))
    return out


def weight_map(w_q: torch.Tensor):
    """The TMA map of w_q (O, KH, KW, C) as (O, K) rows, built once per
    weight tensor (a copy with rows padded to 16 bytes where K % 16 != 0)."""
    version = -1 if w_q.is_inference() else w_q._version
    key = (w_q.data_ptr(), tuple(w_q.shape), version, w_q.device)
    hit = _WEIGHT_MAPS.get(key)
    if hit is None:
        o = w_q.shape[0]
        rows, ld = rows16(w_q.reshape(o, -1))
        buf = ctypes.create_string_buffer(128)
        err = _WEIGHT_MAP(rows.data_ptr(), o, rows.shape[1], ld, buf)
        if err != 0:
            raise RuntimeError(f"int8_conv weight map failed: error {err}")
        hit = _WEIGHT_MAPS[key] = (w_q, rows, buf)
        while len(_WEIGHT_MAPS) > _WEIGHT_MAPS_CAP:
            _WEIGHT_MAPS.popitem(last=False)
    return hit[2]


def plan(o: int, out_dtype: torch.dtype = torch.int8) -> dict:
    """The tile, stage count and dynamic shared memory of a launch with O
    output channels writing out_dtype (built on first use)."""
    out = (ctypes.c_int * 4)()
    _PLAN(o, _MODES[out_dtype], out)
    return dict(tile=(out[0], out[1]), stages=out[2], smem_bytes=out[3])


def int8_conv(x_q, w_q, a, b, stride: int = 1, relu: bool = True,
              out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """conv(int8, int8) -> int32 -> fused epilogue, NHWC in and out, the op
    `yololp_torch::int8_conv` (ops/library.py): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    profiler.count("int8.convs", 1)
    return torch.ops.yololp_torch.int8_conv(x_q, w_q, a, b, int(stride), bool(relu),
                                            out_mode(out_dtype))


def _by_mode(fn):
    """`fn` (..., out_dtype) as the op calls it, with the kernel's mode number."""
    return lambda x_q, w_q, a, b, stride, relu, mode: fn(x_q, w_q, a, b, stride, relu,
                                                         mode_dtype(mode))


def _empty_out(x_q, w_q, a, b, stride, relu, out_dtype):
    n, h, w, _ = x_q.shape
    o, kh = w_q.shape[:2]
    return x_q.new_empty((n, out_size(h, kh, stride), out_size(w, kh, stride), o),
                         dtype=out_dtype)


OPS = (_build.Op("int8_conv(Tensor x_q, Tensor w_q, Tensor a, Tensor b, int stride, bool relu, "
                 "int out_mode) -> Tensor", "int8_conv", _by_mode(_check),
                 _by_mode(int8_conv_plain), _by_mode(int8_conv_cuda), _by_mode(_empty_out)),)


def conv3x3_int8_fused(x_q, w9, a, b, relu: bool = True,
                       out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The signature of the JAX `conv3x3_int8_fused`: x_q (N, S, S, C) int8,
    w9 (9, C, O) int8 (the HWIO kernel reshaped tap-major), a and b (O,)
    f32 -> (N, S, S, O) in out_dtype, 3x3, stride 1, pad 1."""
    n, s, s2, c = x_q.shape
    if s != s2:
        raise ValueError(f"square feature maps only, got {s}x{s2}")
    o = w9.shape[-1]
    w_q = w9.permute(2, 0, 1).reshape(o, 3, 3, c).contiguous()
    return int8_conv(x_q.contiguous(), w_q, a.float().contiguous(), b.float().contiguous(),
                     1, relu, out_dtype)


def quantize_codes(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """clip(round_half_even(x / scale), -128, 127) as int8, in fp32, with the
    division as the jitted JAX package computes it (its scale is a trace-time
    constant): a multiply by `inv_scale`, from `inv_host_scale`. The op
    `yololp_torch::quantize_codes` (ops/cuda_quantize.py: csrc/quantize.cu on
    the card, which counts its launches in `int8.quantize_fused`). The span
    `int8.quantize`, counting its elements in `int8.quantized`."""
    with profiler.annotate("int8.quantize", x.device):
        profiler.count("int8.quantized", x.numel())
        return torch.ops.yololp_torch.quantize_codes(x, float(inv_scale))


def host_scale(amax: float) -> torch.Tensor:
    """amax / 127 in fp32 (the JAX package's `jnp.float32(amax) / 127.0`, a
    true division: eager, or folded as a constant under jit), computed on the
    host: CUDA divides a tensor by a Python scalar as a multiply by its
    reciprocal, which can differ in the last bit, and one bit of a scale can
    flip a code."""
    return torch.tensor(amax, dtype=torch.float32) / 127.0


def inv_host_scale(amax: float) -> float:
    """fp32(1 / host_scale(amax)): the reciprocal XLA multiplies by where the
    jitted JAX package quantizes `x / scale` (ops/division.py)."""
    return reciprocal(float(host_scale(amax)))


def chain_links(sub_paths: Sequence[str], amax_by_path: Dict[str, float], weight_table,
                out_dtype: torch.dtype, exit_amax=None):
    """(entry inverse scale, [(w_q, a, b, out_dtype)] per link) of a deploy RepBlock
    chain. Interior links requantize to the next link's scale, relu folded
    into the clip: a = s_i * w_scale / s_next, b = bias / s_next. The last
    link dequantizes (a = s_i * w_scale, b = bias, relu, `out_dtype`) or,
    with `exit_amax`, requantizes to the consumer's scale. The constants are
    computed on the host in fp32, as the JAX package computes them, and
    moved to the weights' device, so that they do not depend on it."""
    scales = [host_scale(amax_by_path[p]) for p in sub_paths]
    links = []
    for i, p in enumerate(sub_paths):
        w_q, w_scale, bias = weight_table[p]
        dev = w_q.device
        w_scale, bias = w_scale.cpu(), bias.cpu()
        if i + 1 < len(sub_paths) or exit_amax is not None:
            s_next = scales[i + 1] if i + 1 < len(sub_paths) else host_scale(exit_amax)
            a, b, dt = scales[i] * w_scale / s_next, bias / s_next, torch.int8
        else:
            a, b, dt = scales[i] * w_scale, bias, out_dtype
        links.append((w_q, a.to(dev), b.to(dev), dt))
    return inv_host_scale(amax_by_path[sub_paths[0]]), links


def run_chain(x: torch.Tensor, entry_inv_scale: float, links) -> torch.Tensor:
    """Run chain_links' links on NHWC `x`: quantize at entry (an int8 `x` is
    taken as codes at the entry scale), then each link with relu."""
    q = x.contiguous() if x.dtype == torch.int8 else quantize_codes(x, entry_inv_scale)
    for w_q, a, b, dt in links:
        q = int8_conv(q, w_q, a, b, 1, True, dt)
    return q


def chain_repblock_fused(x, sub_paths, amax_by_path, weight_table, out_dtype=None):
    """Counterpart of the JAX `chain_repblock_pallas`: a deploy RepBlock
    chain of 3x3 links, NHWC. Quantize once at entry (an int8 `x` is taken as
    codes at the first link's scale), run each interior link int8 -> int8
    with relu folded into the clip, and dequantize the last link with relu to
    `out_dtype` (no exit handoff). `weight_table[p]` is (w_q (O, 3, 3, C)
    int8, w_scale (O,) f32, bias (O,) f32)."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    return run_chain(x, *chain_links(sub_paths, amax_by_path, weight_table, out_dtype))
