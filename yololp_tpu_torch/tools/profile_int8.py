"""int8 conv rates and the int8 plan grid end to end (counterpart of
tools/profile_int8.py).

1. `conv_rates`: a bare 3x3 conv at each backbone-stage geometry of yololps,
   cuDNN bf16 against csrc/int8_conv.cu in accumulator mode (conv only, no
   epilogue): does int8 run at twice the bf16 rate?
2. `e2e_variants`: the deploy forward + NMS in bf16 against the int8 plan
   grid {per-conv, handoff, chained, chained+handoff, chained+handoff+dots,
   per-conv+dots} of `build_int8_model` (needs --calib-pt): what each
   fusion wins or loses.

Protocol: utils/profiler.timed_scan_delta2 for the convs, utils/profiler.
timed_scan for the forwards (K chained steps; each step's uint8 input is
offset by the step count).

    python -m yololp_tpu_torch.tools.profile_int8 --device cuda --calib-pt amax.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from yololp_tpu_torch.ops import cuda_conv
from yololp_tpu_torch.tools.probe_mxu_int8 import _chain_f, _chain_i, _scan
from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import timed_scan, timed_scan_delta2


def conv_rates(batch: int, img: int, iters: int, dev) -> list:
    """Bare 3x3 conv at each backbone-stage geometry, bf16 against int8; the
    output feeds the next step's input (scaled or shifted and clipped)."""
    rng = np.random.default_rng(0)
    rows = []
    for div, c in ((4, 64), (8, 128), (16, 256), (32, 512)):
        s = img // div
        flops = 2 * batch * s * s * c * c * 9
        xb = (torch.from_numpy(rng.standard_normal((batch, s, s, c)) * 0.1)
              .to(dev, torch.bfloat16).permute(0, 3, 1, 2))  # NCHW view, channels_last
        wb = (torch.from_numpy(rng.standard_normal((c, c, 3, 3)) * 0.01).to(dev, torch.bfloat16)
              .contiguous(memory_format=torch.channels_last))
        t_bf16 = timed_scan_delta2(_scan(lambda x, w: _chain_f(F.conv2d(x, w, padding=1))),
                                   iters, xb, wb)
        xi = torch.from_numpy(rng.integers(-127, 128, (batch, s, s, c)).astype(np.int8)).to(dev)
        wi = torch.from_numpy(rng.integers(-127, 128, (c, 3, 3, c)).astype(np.int8)).to(dev)
        zeros = torch.zeros(c, device=dev)
        t_int8 = timed_scan_delta2(
            _scan(lambda x, w: _chain_i(cuda_conv.int8_conv(x, w, zeros, zeros, 1, False,
                                                            torch.int32))), iters, xi, wi)
        rows.append({"hw": s, "ch": c, "bf16_tflops": flops / t_bf16 / 1e12,
                     "int8_tops": flops / t_int8 / 1e12, "int8_speedup": t_bf16 / t_int8})
    return rows


# (name, chain_repblocks, stage_handoffs, conv_impl): the JAX tool's grid
GRID = (("int8_perconv", False, False, "conv"),
        ("int8_handoff", False, True, "conv"),
        ("int8_chained", True, False, "conv"),
        ("int8_chained_handoff", True, True, "conv"),
        ("int8_chained_handoff_dots", True, True, "dots"),
        ("int8_perconv_dots", False, False, "dots"))


def e2e_variants(args, dev) -> dict:
    """ms per batch of uint8 -> forward -> NMS, bf16 and each int8 plan."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.ops.division import unit_pixels
    from yololp_tpu_torch.ops.nms import non_max_suppression

    b, s, k = args.batch_size, args.img_size, args.iters
    inferer = Inferer(".", args.weights, args.conf_file, img_size=s, half=True, device=dev)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 255, (b, s, s, 3), np.uint8)).to(dev)

    def scan_over(model):
        """K chained steps: each step offsets the uint8 input by the step
        count and reduces the detections' counts."""
        @torch.inference_mode()
        def prog(images_u8, c0):
            c, total = c0, 0
            for _ in range(k):
                xx = unit_pixels((images_u8 + c).permute(0, 3, 1, 2), torch.bfloat16)
                pred = model(xx)
                _, _, num = non_max_suppression(pred.float(), conf_thres=args.conf_thres,
                                                iou_thres=args.iou_thres)
                c, total = c + 1, total + num.sum()
            return total
        return prog

    c0 = torch.zeros((), dtype=torch.uint8, device=dev)
    out = {"bf16_ms": timed_scan(scan_over(inferer.model), k, x, c0) * 1e3}
    if args.calib_pt:
        from yololp_tpu_torch.quant.int8_infer import build_int8_model, quantize_kernels_int8
        from yololp_tpu_torch.quant.quantize import load_amax

        amax = load_amax(args.calib_pt)
        table = quantize_kernels_int8(inferer.variables, device=dev)
        for name, chain, handoff, impl in GRID:
            model = build_int8_model(inferer.model, amax, table, chain_repblocks=chain,
                                     stage_handoffs=handoff, conv_impl=impl)
            out[f"{name}_ms"] = timed_scan(scan_over(model), k, x, c0) * 1e3
        best = min(v for n, v in out.items() if n.startswith("int8"))
        out["int8_best_vs_bf16"] = out["bf16_ms"] / best
    return out


def main(argv=None):
    p = argparse.ArgumentParser("int8 conv rates + e2e plan profiler")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--calib-pt", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--conf-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--skip-micro", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: batch 2, 64 px, 8 steps (overrides those flags)")
    args = p.parse_args(argv)
    if args.small:
        args.batch_size, args.img_size, args.iters = 2, 64, 8
    dev = resolve_device(args.device)

    result = {"platform": dev.type,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if not args.skip_micro:
        result["conv_rates"] = conv_rates(args.batch_size, args.img_size, args.iters, dev)
    result.update(e2e_variants(args, dev))
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
