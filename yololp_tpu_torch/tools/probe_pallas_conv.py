"""Does the fused int8 conv beat an int8 conv with a separate requant pass?
(Counterpart of tools/probe_pallas_conv.py.)

Times one RepBlock chain link (3x3 conv, int8 -> per-channel requant ->
int8) at the yololps@640 stage geometries, three ways:

  bf16      cuDNN bf16 conv + relu (the non-quantized baseline)
  unfused   csrc/int8_conv.cu in accumulator mode, then the requant epilogue
            as separate PyTorch passes (the JAX probe's xla_int8 row:
            conv(int8, int8) -> int32 + a separate epilogue)
  kernel    ops/cuda_conv.conv3x3_int8_fused: conv and requant in one
            launch of int8_conv.cu, int8 in and out (the JAX probe's pallas
            row)

Keys: bf16_tflops, unfused_int8_tops, kernel_int8_tops, kernel_vs_bf16,
kernel_vs_unfused (the JAX probe's xla_int8_tops, pallas_int8_tops,
pallas_vs_bf16, pallas_vs_xla_int8). Protocol: utils/profiler.timed_scan_delta2.

    python -m yololp_tpu_torch.tools.probe_pallas_conv --device cuda
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from yololp_tpu_torch.ops import cuda_conv
from yololp_tpu_torch.tools.probe_mxu_int8 import _scan
from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import timed_scan_delta2


def main(argv=None):
    p = argparse.ArgumentParser("fused int8 conv probe")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--row-tile", type=int, default=None,
                   help="the Pallas kernel's row tile; the CUDA kernel's tile is fixed, "
                        "so this is accepted and not used")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--small", action="store_true", help="CPU smoke shapes")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    b = 2 if args.small else args.batch
    geoms = [(16, 128)] if args.small else [(160, 64), (80, 128), (40, 256), (20, 512)]
    k = args.iters
    rng = np.random.default_rng(0)
    out = {"platform": dev.type,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "B": b, "rows": []}
    for s, c in geoms:
        flops = 2 * b * s * s * c * c * 9
        a = torch.from_numpy(rng.random(c) * 2e-3 + 1e-4).to(dev, torch.float32)
        bias = torch.from_numpy(rng.standard_normal(c) * 0.1).to(dev, torch.float32)
        zeros = torch.zeros(c, device=dev)
        xb = torch.from_numpy(rng.standard_normal((b, s, s, c)) * 0.1).to(dev, torch.bfloat16)
        xb = xb.permute(0, 3, 1, 2)  # NCHW view, channels_last
        wb = (torch.from_numpy(rng.standard_normal((c, c, 3, 3)) * 0.01).to(dev, torch.bfloat16)
              .contiguous(memory_format=torch.channels_last))
        xi = torch.from_numpy(rng.integers(0, 128, (b, s, s, c)).astype(np.int8)).to(dev)
        w9 = torch.from_numpy(rng.integers(-127, 128, (9, c, c)).astype(np.int8)).to(dev)
        wi = w9.permute(2, 0, 1).reshape(c, 3, 3, c).contiguous()  # (O, KH, KW, C)

        def unfused(x, w):
            acc = cuda_conv.int8_conv(x, w, zeros, zeros, 1, False, torch.int32)
            return cuda_conv.epilogue_plain(acc, a, bias, True, torch.int8)

        def fused(x, w):
            return cuda_conv.conv3x3_int8_fused(x, w, a, bias, relu=True, out_dtype=torch.int8)

        row = {"S": s, "C": c}
        t_bf16 = timed_scan_delta2(_scan(lambda x, w: torch.relu(F.conv2d(x, w, padding=1))),
                                   k, xb, wb)
        row["bf16_tflops"] = flops / t_bf16 / 1e12
        t_unf = timed_scan_delta2(_scan(unfused), k, xi, wi)
        row["unfused_int8_tops"] = flops / t_unf / 1e12
        t_ker = timed_scan_delta2(_scan(fused), k, xi, w9)
        row["kernel_int8_tops"] = flops / t_ker / 1e12
        row["kernel_vs_bf16"] = t_bf16 / t_ker
        row["kernel_vs_unfused"] = t_unf / t_ker
        out["rows"].append(row)
        print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
