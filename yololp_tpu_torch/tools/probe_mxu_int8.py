"""Does int8 reach twice the bf16 rate on this card's tensor cores, and
through which route? (Counterpart of tools/probe_mxu_int8.py.)

Times the same contraction through each route, bf16 and int8:

  matmul kernel   csrc/mxu_matmul.cu, the counterpart of the Pallas
                  `_mm_kernel` (keys kernel_*, the JAX probe's pallas_*)
  matmul library  torch.matmul in bf16 (cuBLAS; its output is bf16, not
                  fp32) and torch._int_mm in int8 (keys library_*, the JAX
                  probe's xla_*): yardsticks, never used by the port
  conv, bf16      cuDNN's F.conv2d, 3x3
  conv, int8      csrc/int8_conv.cu in accumulator mode (the port's only int8
                  conv; the JAX probe's conv_xla_int8)
  conv 9 dots     a 3x3 conv as 9 shifted matmuls on the kernel

Protocol: utils/profiler.timed_scan_delta2 (K chained steps, each step's
input computed from the previous output; median of 3 alternating calls of
the K- and 2K-step loops, differenced, with the K->2K scaling guard: a
measurement that does not scale is taken anew at twice the K).

    python -m yololp_tpu_torch.tools.probe_mxu_int8 --device cuda
    python -m yololp_tpu_torch.tools.probe_mxu_int8 --device cpu --small
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from yololp_tpu_torch.ops import cuda_conv, cuda_matmul
from yololp_tpu_torch.quant.int8_infer import conv3x3_as_dots
from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import timed_scan_delta2


def _chain_f(y: torch.Tensor) -> torch.Tensor:
    """(M, N) float -> the next (M, N) bf16 input, finite."""
    return (y * 1e-2).to(torch.bfloat16)


def _chain_i(y: torch.Tensor) -> torch.Tensor:
    """(M, N) int32 -> the next (M, N) int8 input."""
    return torch.clamp(y >> 12, -127, 127).to(torch.int8)


def _scan(step):
    """make_fn_of_k for timed_scan_delta2: k chained steps of `step`."""
    def of_k(k):
        def run(x0, w):
            x = x0
            for _ in range(k):
                x = step(x, w)
            return x
        return run
    return of_k


def matmul_case(m: int, k: int, iters: int, use_kernel: bool, dev, rng):
    """Square-K chained matmul x_{t+1} = g(x_t @ w): (bf16 s, int8 s) per
    step, through the kernel or the library."""
    if use_kernel:
        mm_f = mm_i = cuda_matmul.matmul
    else:
        mm_f, mm_i = torch.matmul, torch._int_mm
    xb = torch.from_numpy(rng.standard_normal((m, k)) * 0.1).to(dev, torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal((k, k)) * 0.05).to(dev, torch.bfloat16)
    t_f = timed_scan_delta2(_scan(lambda x, w: _chain_f(mm_f(x, w))), iters, xb, wb)
    xi = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    wi = torch.from_numpy(rng.integers(-127, 128, (k, k)).astype(np.int8)).to(dev)
    t_i = timed_scan_delta2(_scan(lambda x, w: _chain_i(mm_i(x, w))), iters, xi, wi)
    return t_f, t_i


def conv9dots(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """3x3 same conv as 9 shifted (N*H*W, C) @ (C, C) int8 matmuls on the
    kernel, int32 partials summed. x (N, H, W, C) int8, w9 (9, C, C) int8
    (the HWIO kernel reshaped tap-major)."""
    c = x.shape[-1]
    return conv3x3_as_dots(x, w9.reshape(3, 3, c, -1))


def conv_case(b: int, s: int, c: int, iters: int, dev, rng) -> dict:
    """A 3x3 same-channel conv at one model geometry: cuDNN bf16, the int8
    conv kernel and the 9-dots int8 route; seconds per step."""
    xb = torch.from_numpy(rng.standard_normal((b, s, s, c)) * 0.1).to(dev, torch.bfloat16)
    xb = xb.permute(0, 3, 1, 2)  # NCHW view, channels_last
    wb = (torch.from_numpy(rng.standard_normal((c, c, 3, 3)) * 0.01).to(dev, torch.bfloat16)
          .contiguous(memory_format=torch.channels_last))
    xi = torch.from_numpy(rng.integers(-127, 128, (b, s, s, c)).astype(np.int8)).to(dev)
    wi = torch.from_numpy(rng.integers(-127, 128, (c, 3, 3, c)).astype(np.int8)).to(dev)
    w9 = torch.from_numpy(rng.integers(-127, 128, (9, c, c)).astype(np.int8)).to(dev)
    zeros = torch.zeros(c, device=dev)

    def conv_int8(x, w):
        return cuda_conv.int8_conv(x, w, zeros, zeros, 1, False, torch.int32)

    return {
        "conv_bf16_s": timed_scan_delta2(
            _scan(lambda x, w: _chain_f(F.conv2d(x, w, padding=1))), iters, xb, wb),
        "conv_int8_s": timed_scan_delta2(
            _scan(lambda x, w: _chain_i(conv_int8(x, w))), iters, xi, wi),
        "conv_9dots_int8_s": timed_scan_delta2(
            _scan(lambda x, w: _chain_i(conv9dots(x, w))), iters, xi, w9),
    }


def main(argv=None):
    p = argparse.ArgumentParser("tensor-core int8 rate probe")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--bm", type=int, default=512,
                   help="the Pallas probe's M tile; the CUDA kernel's tile is fixed "
                        "(128 rows), so this is accepted and not used")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--skip-pallas", action="store_true",
                   help="skip the matmul kernel (the Pallas kernel's counterpart)")
    p.add_argument("--small", action="store_true", help="tiny shapes (CPU smoke)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    out = {"platform": dev.type,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    mm_shapes = [(256, 128)] if args.small else [(16384, 512), (8192, 1024), (4096, 2048)]
    mm_iters = args.iters if args.small else args.iters * 5
    rows = []
    for m, k in mm_shapes:
        flops = 2 * m * k * k  # per step
        row = {"M": m, "K": k, "library_bf16_out_dtype": "bfloat16"}
        t_f, t_i = matmul_case(m, k, mm_iters, False, dev, rng)
        row["library_bf16_tflops"] = flops / t_f / 1e12
        row["library_int8_tops"] = flops / t_i / 1e12
        row["library_int8_speedup"] = t_f / t_i
        if not args.skip_pallas:
            t_f, t_i = matmul_case(m, k, mm_iters, True, dev, rng)
            row["kernel_bf16_tflops"] = flops / t_f / 1e12
            row["kernel_int8_tops"] = flops / t_i / 1e12
            row["kernel_int8_speedup"] = t_f / t_i
        rows.append(row)
    out["matmul"] = rows

    conv_shapes = [(2, 16, 64)] if args.small else [(128, 80, 128), (128, 40, 256), (128, 20, 512)]
    crows = []
    for b, s, c in conv_shapes:
        flops = 2 * b * s * s * c * c * 9
        r = conv_case(b, s, c, args.iters, dev, rng)
        crows.append({
            "B": b, "S": s, "C": c,
            "conv_bf16_tflops": flops / r["conv_bf16_s"] / 1e12,
            "conv_int8_tops": flops / r["conv_int8_s"] / 1e12,
            "conv_int8_speedup": r["conv_bf16_s"] / r["conv_int8_s"],
            "c9dots_int8_tops": flops / r["conv_9dots_int8_s"] / 1e12,
            "c9dots_vs_conv_bf16": r["conv_bf16_s"] / r["conv_9dots_int8_s"],
        })
    out["conv3x3"] = crows
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
