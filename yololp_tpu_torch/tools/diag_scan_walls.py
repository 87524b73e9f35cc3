"""Raw-wall diagnostic for the chained-loop timing protocol of
utils/profiler.py (mirrors tools/diag_scan_walls.py of the JAX package).

The probes difference the walls of K- and 2K-step chained loops
(`timed_scan_delta2`); when such a difference does not cancel, this prints
every raw wall it would difference, for one conv geometry, so the term that
does not cancel shows directly:

  for K in (20, 40): the first (warm-up) wall, three walls on the same
  buffers, three on fresh buffers (`fresh_operands`, made outside the wall);
  the same for an empty body (the loop's own cost a step); and the wall of
  making fresh operands.

The body is a bf16 3x3 conv, stride 1, pad 1, (B, C, S, S) channels_last
through cuDNN (F.conv2d), its output scaled by 1e-2 in fp32 and cast back
to bf16, as the JAX tool's lax.conv in a scan. A plain PyTorch chain, not a
kernel of this package. Walls are CUDA events on the card, the host clock on
the CPU (`--device cpu`, `--small` for a tiny geometry). Prints one JSON
object.

  python -m yololp_tpu_torch.tools.diag_scan_walls [--batch 128 --size 80 --chan 128]
"""

from __future__ import annotations

import argparse
import json
import time


def get_args_parser():
    p = argparse.ArgumentParser("scan-wall diagnostic (PyTorch/CUDA)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=80)
    p.add_argument("--chan", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--small", action="store_true", help="B, S, C = 2, 16, 16")
    return p


def _wall(fn, *op) -> float:
    """Seconds of one call of fn(*op): CUDA events around it on the card, the
    host clock on the CPU (where torch runs synchronously)."""
    import torch

    dev = op[0].device
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*op)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn(*op)
    return time.perf_counter() - t0


def scan_walls(batch: int, size: int, chan: int, device) -> dict:
    """The walls (seconds) of K = 20 and 40 chained conv and empty steps."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from yololp_tpu_torch.utils.profiler import fresh_operands

    B, S, C = batch, size, chan
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((B, S, S, C)) * 0.1).to(
        device, torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
    wb = torch.from_numpy(rng.standard_normal((3, 3, C, C)) * 0.01).to(
        device, torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    flops = 2 * B * S * S * C * C * 9

    def make_conv(k):
        def run(x, w):
            for _ in range(k):
                y = F.conv2d(x, w, padding=1)
                x = (y.float() * 1e-2).to(torch.bfloat16)
            return x
        return run

    def make_empty(k):
        def run(x, w):
            for _ in range(k):
                pass
            return x + w[0, 0, 0, 0]
        return run

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out = {"B": B, "S": S, "C": C, "device": str(device),
           "conv_gflop_per_iter": flops / 1e9}
    with torch.inference_mode():
        t0 = time.perf_counter()
        fresh_operands((xb, wb))
        sync()
        out["fresh_operands_blocked_s"] = time.perf_counter() - t0
        for name, make in (("conv", make_conv), ("empty", make_empty)):
            for k in (20, 40):
                fn = make(k)
                out[f"{name}_k{k}_compile_warm_s"] = _wall(fn, xb, wb)
                for i in range(3):
                    out[f"{name}_k{k}_same_{i}_s"] = _wall(fn, xb, wb)
                for i in range(3):
                    op2 = [t.contiguous(memory_format=torch.channels_last)
                           for t in fresh_operands((xb, wb))]
                    sync()
                    out[f"{name}_k{k}_freshbuf_{i}_s"] = _wall(fn, *op2)
    return out


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    import torch

    from yololp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.small:
        args.batch, args.size, args.chan = 2, 16, 16
    out = scan_walls(args.batch, args.size, args.chan, dev)
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
