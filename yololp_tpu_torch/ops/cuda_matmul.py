"""(M, K) @ (K, N) on the tensor cores: the CUDA kernel csrc/mxu_matmul.cu and
its plain PyTorch version.

Counterpart of `_mm_kernel` / `pallas_matmul` (tools/probe_mxu_int8.py:44),
the probe's tiled matmul, and the product under the `dots` lowering of the
int8 convs (quant/int8_infer.py:conv3x3_as_dots). `matmul` runs the kernel
on CUDA tensors and the plain version on CPU tensors; on CUDA tensors it
launches the kernel or raises. `launches` counts the kernel's launches.

Types: bf16 x bf16 -> fp32, int8 x int8 -> int32. Both operands row-major
and contiguous, `b` in the public (K, N) layout (the kernel transposes its
tiles of `b` while staging them). Any M, N, K.

The kernel's bound at the probe's shapes (each input read once, the output
written once, at 3.35 TB/s; 2 ops a multiply-add at 989 TFLOP/s bf16 or
1979 TOP/s int8, H100 SXM data sheet): (16384, 512) @ (512, 512) 15.2 us
bf16 / 12.6 us int8, bytes; (8192, 1024) @ (1024, 1024) 17.4 us bf16,
operations / 12.8 us int8, bytes; (4096, 2048) @ (2048, 2048) 34.7 us bf16 /
17.4 us int8, operations.
"""

from __future__ import annotations

import ctypes

import torch

from yololp_tpu_torch.ops import _build

launches = 0

# input dtype -> (the kernel's mode, output dtype)
_MODES = {torch.int8: (0, torch.int32), torch.bfloat16: (1, torch.float32)}


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch. int8: exact, in fp64 (every
    partial sum is an integer of magnitude <= K * 2**14, far below 2**53).
    bf16: an fp32 product of the up-cast values with TF32 off; the products
    of two bf16 values are exact in fp32, so it differs from the kernel only
    in the order of the fp32 sums."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.float() @ b.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a must be (M, K) and b (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner sizes differ: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _MODES:
        raise TypeError(f"a and b must both be one of {list(_MODES)}, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous (row-major)")


def _bind(lib: ctypes.CDLL):
    fn = lib.mxu_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch csrc/mxu_matmul.cu on CUDA tensors; raise on any refusal."""
    global launches
    _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {a.device}")
    (m, k), n = a.shape, b.shape[1]
    mode, out_dtype = _MODES[a.dtype]
    if k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = _bind(_build.load("mxu_matmul"))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, mode,
             a.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"mxu_matmul kernel launch failed: cudaError {err}")
    launches += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N), bf16 -> fp32 or int8 -> int32: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if a.device.type == "cuda":
        return matmul_cuda(a, b)
    if a.device.type == "cpu":
        _check(a, b)
        return matmul_plain(a, b)
    raise ValueError(f"no matmul for device {a.device}")
