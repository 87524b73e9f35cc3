"""(M, K) @ B on the tensor cores: the CUDA kernel csrc/mxu_matmul.cu and its
plain PyTorch version.

Counterpart of `_mm_kernel` / `pallas_matmul` (tools/probe_mxu_int8.py:44),
the probe's tiled matmul, and the product under the `dots` lowering of the
int8 convs (quant/int8_infer.py:conv3x3_as_dots). `matmul` and `matmul_nt`
run the kernel on CUDA tensors and the plain version on CPU tensors; on CUDA
tensors they launch the kernel or raise. `_build.launches("mxu_matmul")`
counts the kernel's launches.

Types: bf16 x bf16 -> fp32, int8 x int8 -> int32. Two entries:
- `matmul(a, b)`: a (M, K) and b (K, N), both contiguous (the JAX
  `pallas_matmul` layout). The kernel takes int8 B K-major only (8-bit wgmma
  has no transposed B), so int8 `b` goes to it as a (N, K) copy; bf16 `b` is
  read as it is (MN-major) where N > 16 and N % 8 == 0. A copy with rows
  padded to 16 bytes is made of an operand whose rows do not start on 16
  bytes.
- `matmul_nt(a, b_t)`: a (M, K), b_t (N, K), unit column stride and rows
  that start on 16 bytes (the row stride may exceed K: a conv tap's weights
  `w_q[:, dy, dx, :]` of a (O, 3, 3, C) tensor are taken as they are). No
  copy is made; other layouts raise on CUDA.

The kernel's bound at the probe's shapes (each input read once, the output
written once, at 3.35 TB/s; 2 ops a multiply-add at 989 TFLOP/s bf16 or
1979 TOP/s int8, H100 SXM data sheet): (16384, 512) @ (512, 512) 15.2 us
bf16 / 12.6 us int8, bytes; (8192, 1024) @ (1024, 1024) 17.4 us bf16,
operations / 12.8 us int8, bytes; (4096, 2048) @ (2048, 2048) 34.7 us bf16 /
17.4 us int8, operations.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from yololp_tpu_torch.ops import _build

# input dtype -> (the kernel's mode, output dtype)
_MODES = {torch.int8: (0, torch.int32), torch.bfloat16: (1, torch.float32)}

_LAUNCH = _build.Kernel("mxu_matmul", "mxu_matmul_launch",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_int],
                        failure="error {} (a cudaError_t, or 9999 / 10000 + CUresult from the "
                                "tensor-map encoder)")
_PLAN = _build.Entry("mxu_matmul", "mxu_matmul_plan", [ctypes.c_longlong, ctypes.c_void_p],
                     restype=None)


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


def matmul_nt_plain(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a @ b_t.T in plain PyTorch (matmul_plain on the transposed view)."""
    return matmul_plain(a, b_t.t())


def _check_types(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != b.dtype or a.dtype not in _MODES:
        raise TypeError(f"a and b must both be one of {list(_MODES)}, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")


def _empty(a: torch.Tensor, n: int) -> torch.Tensor:
    return a.new_empty((a.shape[0], n), dtype=_MODES[a.dtype][1])


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a must be (M, K) and b (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner sizes differ: a {tuple(a.shape)}, b {tuple(b.shape)}")
    _check_types(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous (row-major)")


def _check_nt(a: torch.Tensor, b_t: torch.Tensor) -> None:
    if a.dim() != 2 or b_t.dim() != 2:
        raise ValueError(f"a must be (M, K) and b_t (N, K), got {tuple(a.shape)} and "
                         f"{tuple(b_t.shape)}")
    if a.shape[1] != b_t.shape[1]:
        raise ValueError(f"inner sizes differ: a {tuple(a.shape)}, b_t {tuple(b_t.shape)}")
    _check_types(a, b_t)


def rows16_ok(t: torch.Tensor) -> bool:
    """Whether 2-d `t` is what the kernels' tensor maps take as it is: unit
    column stride, rows that start on 16 bytes (row stride and address)."""
    es = t.element_size()
    return (t.stride(1) == 1 or t.shape[1] <= 1) and (t.stride(0) * es) % 16 == 0 \
        and t.data_ptr() % 16 == 0


def rows16(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(tensor, row stride in elements) of 2-d `t` as the tensor maps take
    it: `t` itself where rows16_ok, else a copy whose rows are padded to a
    multiple of 16 bytes (the view of its first t.shape[1] columns)."""
    if rows16_ok(t):
        return t, t.stride(0)
    if (t.shape[1] * t.element_size()) % 16 == 0:
        c = t.contiguous()
        if rows16_ok(c):
            return c, c.stride(0)
    per = 16 // t.element_size()
    ld = -(-t.shape[1] // per) * per
    buf = torch.zeros((t.shape[0], ld), dtype=t.dtype, device=t.device)
    buf[:, :t.shape[1]] = t
    return buf[:, :t.shape[1]], ld


def plan(n: int) -> dict:
    """The tile, stage count and dynamic shared memory of a launch with N
    output columns (built on first use)."""
    out = (ctypes.c_int * 4)()
    _PLAN(n, out)
    return dict(tile=(out[0], out[1]), stages=out[2], smem_bytes=out[3])


def _launch(a, lda, b, ldb, b_mn: bool, n: int) -> torch.Tensor:
    """One launch: a (M, K) rows lda apart; b (N, K) rows ldb apart, or with
    b_mn (K, N) rows ldb apart."""
    m, k = a.shape
    mode, out_dtype = _MODES[a.dtype]
    if k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    _LAUNCH.launch(a.device, a.data_ptr(), lda, b.data_ptr(), ldb, int(b_mn), out.data_ptr(), m,
                   n, k, mode)
    return out


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch csrc/mxu_matmul.cu on CUDA tensors a (M, K), b (K, N); raise
    on any refusal."""
    _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {a.device}")
    n = b.shape[1]
    a_k, lda = rows16(a)
    if a.dtype == torch.bfloat16 and n > 16 and n % 8 == 0 and b.data_ptr() % 16 == 0:
        return _launch(a_k, lda, b, n, True, n)
    b_t, ldb = rows16(b.t())
    return _launch(a_k, lda, b_t, ldb, False, n)


def matmul_nt_cuda(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Launch csrc/mxu_matmul.cu on a (M, K) and K-major b_t (N, K) as they
    are; raise on a layout the tensor maps do not take, or any refusal."""
    _check_nt(a, b_t)
    for name, t in (("a", a), ("b_t", b_t)):
        if not rows16_ok(t):
            raise ValueError(f"{name} {tuple(t.shape)} stride {t.stride()}: the kernel takes "
                             "unit column stride and rows that start on 16 bytes")
    if a.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {a.device}")
    return _launch(a, a.stride(0), b_t, b_t.stride(0), False, b_t.shape[0])


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N), bf16 -> fp32 or int8 -> int32, the op
    `yololp_torch::matmul` (ops/library.py): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return torch.ops.yololp_torch.matmul(a, b)


def matmul_nt(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b_t (N, K).T, bf16 -> fp32 or int8 -> int32, with b_t's
    rows possibly strided, the op `yololp_torch::matmul_nt`
    (ops/library.py): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    return torch.ops.yololp_torch.matmul_nt(a, b_t)


OPS = (_build.Op("matmul(Tensor a, Tensor b) -> Tensor", "mxu_matmul", _check, matmul_plain,
                 matmul_cuda, lambda a, b: _empty(a, b.shape[1])),
       _build.Op("matmul_nt(Tensor a, Tensor b_t) -> Tensor", "mxu_matmul", _check_nt,
                 matmul_nt_plain, matmul_nt_cuda, lambda a, b_t: _empty(a, b_t.shape[0])))
