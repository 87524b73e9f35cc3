"""Serving latency and throughput across batch sizes (counterpart of
tools/probe_latency.py).

Sweeps the same end-to-end program (uint8 -> /255 -> fused deploy forward in
bf16 -> decode -> NMS) over batch sizes, in bf16 and, with --int8, in true
int8 (the default conv plan, calibrated (max) on two seeded batches of 8),
and reports ms per batch, ms per image and images per second. Protocol:
utils/profiler.timed_scan (K chained steps in one timed call; each step's
uint8 input is offset by the step count).

Output: one JSON object with rows [{mode, batch, ms_per_batch, ms_per_img,
img_per_s}].

    python -m yololp_tpu_torch.tools.probe_latency --device cuda --int8
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import timed_scan


def main(argv=None):
    p = argparse.ArgumentParser("e2e latency/throughput curve")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batches", type=str, default="1,4,16,64,128")
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: 64 px, batches 1,2, 2 steps (overrides those flags)")
    args = p.parse_args(argv)
    if args.small:
        args.img_size, args.batches, args.iters = 64, "1,2", 2
    dev = resolve_device(args.device)

    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.ops.division import unit_pixels
    from yololp_tpu_torch.ops.nms import non_max_suppression

    s, k = args.img_size, args.iters
    inferer = Inferer(".", None, args.conf_file, img_size=s, half=True, device=dev)
    forwards = {"bf16": inferer.model}
    if args.int8:
        from yololp_tpu_torch.quant.int8_infer import make_int8_infer_fn
        from yololp_tpu_torch.quant.quantize import calibrate

        rng_c = np.random.default_rng(1)
        calib = [rng_c.integers(0, 255, (8, s, s, 3), np.uint8) for _ in range(2)]
        amax = calibrate(inferer.model, calib, method="max", device=dev)
        forwards["int8"] = make_int8_infer_fn(inferer.model, inferer.variables, amax,
                                              with_nms=False, device=dev).int8_model

    rng = np.random.default_rng(0)
    out = {"img_size": s, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "protocol": f"K={k} chained steps in one timed call (CUDA events on the card); "
                       "bf16 fused deploy model, NMS on the device", "rows": []}
    for mode, model in forwards.items():
        for b in (int(v) for v in args.batches.split(",")):
            @torch.inference_mode()
            def prog(images_u8, c0, model=model):
                c, total = c0, 0
                for _ in range(k):
                    x = unit_pixels((images_u8 + c).permute(0, 3, 1, 2), torch.bfloat16)
                    det, _, num = non_max_suppression(model(x).float(), conf_thres=0.4,
                                                      iou_thres=0.45, max_det=300,
                                                      pre_nms_topk=256)
                    c, total = c + 1, total + det.sum() * 1e-9 + num.sum()
                return total

            x = torch.from_numpy(rng.integers(0, 255, (b, s, s, 3), np.uint8)).to(dev)
            dt = timed_scan(prog, k, x, torch.zeros((), dtype=torch.uint8, device=dev))
            row = {"mode": mode, "batch": b, "ms_per_batch": dt * 1e3,
                   "ms_per_img": dt * 1e3 / b, "img_per_s": b / dt}
            out["rows"].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
