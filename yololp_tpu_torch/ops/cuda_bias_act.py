"""A conv's bias add and activation in one pass: the CUDA kernel
csrc/bias_act.cu and its plain PyTorch version.

`bias_act(y, b, act)` calls the custom op `yololp_torch::bias_act`
(ops/library.py), which runs the kernel on a CUDA tensor and the plain
version on a CPU tensor; on a CUDA tensor it launches the kernel or raises.
It returns a new tensor `act(y + b[c])`, with c the channel (dim 1 of the
NCHW tensor y) and `act` 0 none, 1 ReLU, 2 SiLU. `bias_act(y, b, act, x,
alpha)` is the kernel's residual form, `act(y + b[c]) + alpha * x`: a
BottleRep's second conv with its shortcut, x the block's input (y's shape,
dtype and layout) and alpha its one-element weight; it runs kernels of its
own name (`bias_act_residual_kernel`). `_build.launches("bias_act")` counts
both forms' launches.

The kernel replaces no Pallas kernel: XLA fused this epilogue into its
convolution on the TPU, while PyTorch's cuDNN route adds the bias in a
broadcast pass of its own and runs the activation as a third (the deploy
convs of layers/blocks.py run the conv without its bias, then this op). It
is bound by bytes, one read and one write of y: 16-byte vectors a thread on
the flat channels_last array, the channel carried along the vector, the
bias through the read-only cache (the design is in the source).

Its arithmetic is the unfused path's: y + b in fp32, rounded to y's dtype,
then the activation in fp32 on that value, rounded again. y is bfloat16 or
float32, channels_last (the card's layout) or contiguous NCHW, and b its
dtype; anything else raises. The residual form rounds alpha * x to y's
dtype, then the sum, as PyTorch's mul and add do after the plain form.
"""

from __future__ import annotations

import ctypes

import torch

from yololp_tpu_torch.ops import _build

NONE, RELU, SILU = 0, 1, 2
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the dtypes the kernel takes, by its number

_LAUNCH = _build.Kernel("bias_act", "bias_act_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_int])


def _check(y: torch.Tensor, b: torch.Tensor, act: int, x=None, alpha=None):
    if y.dim() != 4:
        raise ValueError(f"y must be a 4-D NCHW tensor, got {tuple(y.shape)}")
    if y.dtype not in DTYPES or b.dtype != y.dtype:
        raise TypeError(f"y and b must be one of {list(DTYPES)} alike, got {y.dtype}, "
                        f"{b.dtype}")
    if b.dim() != 1 or b.shape[0] != y.shape[1]:
        raise ValueError(f"b must be ({y.shape[1]},) for y of {y.shape[1]} channels, got "
                         f"{tuple(b.shape)}")
    if act not in (NONE, RELU, SILU):
        raise ValueError(f"act {act} is not one of 0 (none), 1 (ReLU), 2 (SiLU)")
    if b.device != y.device:
        raise ValueError(f"y on {y.device}, b on {b.device}")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    if not (y.is_contiguous(memory_format=torch.channels_last) or y.is_contiguous()):
        raise ValueError(f"y must be channels_last or contiguous, got strides {y.stride()}")
    if x is not None or alpha is not None:
        refusal = residual_refusal(y, x, alpha)
        if refusal is not None:
            raise refusal


def _layout(y: torch.Tensor):
    """y's memory format as the kernel reads it."""
    return (torch.channels_last if y.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def residual_refusal(y: torch.Tensor, x, alpha):
    """Why the residual form does not take `x` and `alpha` beside the conv
    output `y` (the exception it raises), or None where it takes them: both
    given, x has y's shape, dtype, device and memory format, alpha is one
    element of y's dtype on y's device."""
    if x is None or alpha is None:
        return ValueError("the residual form takes x and alpha together")
    if x.dtype != y.dtype or alpha.dtype != y.dtype:
        return TypeError(f"x and alpha must be y's {y.dtype}, got {x.dtype}, {alpha.dtype}")
    if x.shape != y.shape:
        return ValueError(f"x must have y's shape {tuple(y.shape)}, got {tuple(x.shape)}")
    if x.device != y.device or alpha.device != y.device:
        return ValueError(f"y on {y.device}, x on {x.device}, alpha on {alpha.device}")
    if not x.is_contiguous(memory_format=_layout(y)):
        return ValueError(f"x must be laid out as y ({_layout(y)}), got strides {x.stride()}")
    if alpha.numel() != 1:
        return ValueError(f"alpha must be one element, got {tuple(alpha.shape)}")
    return None


def bias_act_plain(y: torch.Tensor, b: torch.Tensor, act: int, x: torch.Tensor | None = None,
                   alpha: torch.Tensor | None = None) -> torch.Tensor:
    """act(y + b[c]), with x then `+ alpha * x`, in plain PyTorch, in the
    kernel's arithmetic; the output keeps y's layout. The add is in y's
    dtype, which PyTorch computes in fp32 and rounds once; so are alpha * x
    and the residual's add, as the unfused path and the kernel round them.
    Written as an explicit fp32 -> bf16 -> fp32 chain, the rounding is
    dropped by torch 2.11's Inductor (its joint-graph pass
    `pointless_convert`) when export.inductor_program decomposes the op: the
    SiLU then read the unrounded sum, and 31% of its bf16 outputs differed
    from the kernel's on an H100."""
    z = y + b.reshape(1, -1, 1, 1)
    if act != NONE:
        v = z.float()
        z = (torch.where(v < 0, 0.0, v) if act == RELU else v / (1.0 + torch.exp(-v))).to(y.dtype)
    return z if x is None else z + alpha * x


def bias_act_cuda(y: torch.Tensor, b: torch.Tensor, act: int, x: torch.Tensor | None = None,
                  alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Launch csrc/bias_act.cu (its residual form with `x`) on CUDA tensors;
    raise on any refusal."""
    _check(y, b, act, x, alpha)
    if y.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {y.device}")
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    # channel of flat element e: (e / inner) % C
    inner = 1 if _layout(y) == torch.channels_last else y.shape[2] * y.shape[3]
    _LAUNCH.launch(y.device, y.data_ptr(), b.data_ptr(), None if x is None else x.data_ptr(),
                   None if alpha is None else alpha.data_ptr(), out.data_ptr(), y.numel(),
                   y.shape[1], inner, DTYPES[y.dtype], int(act))
    return out


def bias_act(y: torch.Tensor, b: torch.Tensor, act: int, x: torch.Tensor | None = None,
             alpha: torch.Tensor | None = None) -> torch.Tensor:
    """act(y + b[c]), with x then `+ alpha * x`, through the op
    `yololp_torch::bias_act`: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    return torch.ops.yololp_torch.bias_act(y, b, int(act), x, alpha)


OPS = (_build.Op("bias_act(Tensor y, Tensor b, int act, Tensor? x=None, Tensor? alpha=None) -> "
                 "Tensor", "bias_act", _check, bias_act_plain, bias_act_cuda,
                 lambda y, b, act, x=None, alpha=None: torch.empty_like(y), decompose=True),)
