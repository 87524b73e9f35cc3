"""The float -> int8 code quantize in one pass: the CUDA kernel
csrc/quantize.cu and its plain PyTorch version.

The int8 plan's quantize, `cuda_conv.quantize_codes(x, inv_scale)`, calls
the custom op `yololp_torch::quantize_codes` (ops/library.py), which runs
the kernel on a CUDA tensor and the plain version on a CPU tensor; on a
CUDA tensor it launches the kernel or raises. It returns
`clip(round_half_even(x * inv_scale), -128, 127)` as int8, computed in
fp32, with x's shape and strides. `_build.launches("quantize")` counts the
kernel's launches, and the counter `int8.quantize_fused` those made while
spans record (the metric `quantize_fused.int8`).

The kernel replaces no Pallas kernel: XLA fused the quantize into its int8
conv's input on the TPU, while PyTorch runs it as five passes (the plain
version). It is bound by bytes, one read of x and one write of the codes
(the design is in the source), and its codes are the plain version's bit for
bit. The kernel takes a bfloat16 or float32 tensor whose memory is dense
(any layout: the function is elementwise); anything else raises. The plain
version takes any floating tensor.
"""

from __future__ import annotations

import ctypes

import torch

from yololp_tpu_torch.ops import _build
from yololp_tpu_torch.utils import profiler

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the dtypes the kernel takes, by its number

_LAUNCH = _build.Kernel("quantize", "quantize_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_int])


def _check(x: torch.Tensor, inv_scale: float):
    if not x.is_floating_point():
        raise TypeError(f"x must be a floating tensor, got {x.dtype}")


def is_dense(x: torch.Tensor) -> bool:
    """Whether x's elements fill its memory without gaps or overlaps, in
    some order of its dimensions (a permuted contiguous tensor)."""
    if x.numel() == 0:
        return True
    expected = 1
    for stride, size in sorted((st, s) for s, st in zip(x.shape, x.stride()) if s != 1):
        if stride != expected:
            return False
        expected *= size
    return True


def widened(x: torch.Tensor) -> torch.Tensor:
    """x in float32, exactly. A bfloat16 x is widened through its bits (they
    are the high half of the float32's), not by a cast: written as a cast,
    the op's decomposition let Inductor's fused loop read a SiLU's output
    before its rounding to bfloat16 (an H100, torch 2.11: 3.9% of the codes
    of an AOTInductor package differed from eager's; none through the bits)."""
    if x.dtype != torch.bfloat16:
        return x.float()
    return (x.view(torch.int16).to(torch.int32) << 16).view(torch.float32)


def quantize_codes_plain(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """The codes in plain PyTorch: eager passes, the kernel's arithmetic."""
    return torch.round(widened(x) * inv_scale).clamp(-128.0, 127.0).to(torch.int8)


def quantize_codes_cuda(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """Launch csrc/quantize.cu on a CUDA tensor; raise on any refusal."""
    _check(x, inv_scale)
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {list(DTYPES)}, got {x.dtype}")
    if not is_dense(x):
        raise ValueError(f"x must be dense (a permuted contiguous tensor), got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {x.device}")
    out = torch.empty_like(x, dtype=torch.int8)
    if x.numel() == 0:
        return out
    _LAUNCH.launch(x.device, x.data_ptr(), out.data_ptr(), x.numel(), float(inv_scale),
                   DTYPES[x.dtype])
    profiler.count("int8.quantize_fused", 1)
    return out


OPS = (_build.Op("quantize_codes(Tensor x, float inv_scale) -> Tensor", "quantize", _check,
                 quantize_codes_plain, quantize_codes_cuda,
                 lambda x, inv_scale: torch.empty_like(x, dtype=torch.int8), decompose=True),)
