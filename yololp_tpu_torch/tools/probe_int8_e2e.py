"""Attribution ladder for int8-vs-bf16 end-to-end times (counterpart of
tools/probe_int8_e2e.py).

Times, by utils/profiler.timed_scan (K chained steps in one timed call;
each step's uint8 input is offset by the step count), the deploy forward
without NMS:

  bf16                the float forward (the baseline)
  int8_full           the int8 model (build_int8_model), default skips
  int8_skip<...>      more of the network's front kept in bf16: the stem;
                      through ERBlock_2; _3; _4
  int8_backbone_only  the neck and head in bf16
  int8_no_handoffs    no int8 handoffs between convs
  int8_per_conv       no handoffs and no RepBlock chains

then bf16 and int8_full with the NMS (the greedy keep-mask kernel), and a
RepBlock-chain micro at stage-2 geometry (4 links of 3x3 C -> C at
(B, S/8, S/8, 128)): four cuDNN bf16 convs with ReLU against the int8 chain
with its requantizing epilogues (csrc/int8_conv.cu), by
utils/profiler.timed_scan_delta2.

    python -m yololp_tpu_torch.tools.probe_int8_e2e --device cuda --calib-pt amax.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import timed_scan, timed_scan_delta2

# (name, extra skips, build_int8_model flags): the JAX probe's rungs
CUTS = (("int8_full", (), {}),
        ("int8_skip_stem", ("backbone/stem",), {}),
        ("int8_skip_thru_E2", ("backbone/stem", "backbone/ERBlock_2"), {}),
        ("int8_skip_thru_E3", ("backbone/stem", "backbone/ERBlock_2", "backbone/ERBlock_3"), {}),
        ("int8_skip_thru_E4", ("backbone/stem", "backbone/ERBlock_2", "backbone/ERBlock_3",
                               "backbone/ERBlock_4"), {}),
        ("int8_backbone_only", ("neck", "head"), {}),
        ("int8_no_handoffs", (), {"stage_handoffs": False}),
        ("int8_per_conv", (), {"stage_handoffs": False, "chain_repblocks": False}))


def chain_micro(batch: int, img: int, iters: int, dev) -> dict:
    """ms of 4 chained 3x3 C -> C links at stage 2, bf16 (cuDNN, ReLU)
    against int8 (the chain's int8_conv launches)."""
    from yololp_tpu_torch.quant.int8_infer import _chain_repblock

    c, s2 = 128, img // 8
    rng = np.random.default_rng(0)
    paths = [f"micro/link_{i}/conv" for i in range(4)]
    amax = {p: 8.0 for p in paths}
    table = {p: (torch.from_numpy(rng.integers(-127, 128, (c, 3, 3, c)).astype(np.int8)).to(dev),
                 torch.full((c,), 0.01, device=dev), torch.zeros(c, device=dev)) for p in paths}
    xb = torch.from_numpy(rng.standard_normal((batch, s2, s2, c)) * 0.5).to(dev, torch.bfloat16)
    wb = (torch.from_numpy(rng.standard_normal((c, c, 3, 3)) * 0.01).to(dev, torch.bfloat16)
          .contiguous(memory_format=torch.channels_last))

    def bf16_chain(k):
        def run(x0, w):
            x = x0.permute(0, 3, 1, 2)  # NHWC memory as an NCHW view
            for _ in range(k):
                y = x
                for _i in range(4):
                    y = F.relu(F.conv2d(y, w, padding=1))
                x = y * 0.5
            return x
        return run

    def int8_chain(k):
        def run(x0):
            x = x0
            for _ in range(k):
                x = _chain_repblock(x, paths, amax, table) * 0.5
            return x
        return run

    return {"chain_bf16_ms": timed_scan_delta2(bf16_chain, iters, xb, wb) * 1e3,
            "chain_int8_ms": timed_scan_delta2(int8_chain, iters, xb) * 1e3}


def main(argv=None):
    p = argparse.ArgumentParser("int8 e2e attribution ladder")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--calib-pt", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--skip-chain-micro", action="store_true")
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: batch 2, 64 px, 2 steps (overrides those flags)")
    args = p.parse_args(argv)
    if args.small:
        args.batch_size, args.img_size, args.iters = 2, 64, 2
    dev = resolve_device(args.device)

    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.ops.division import unit_pixels
    from yololp_tpu_torch.ops.nms import non_max_suppression
    from yololp_tpu_torch.quant.int8_infer import build_int8_model, quantize_kernels_int8
    from yololp_tpu_torch.quant.quantize import DEFAULT_SKIP_SUBSTRINGS, load_amax

    b, s, k = args.batch_size, args.img_size, args.iters
    inferer = Inferer(".", args.weights, args.conf_file, img_size=s, half=True, device=dev)
    amax = load_amax(args.calib_pt)
    table = quantize_kernels_int8(inferer.variables, device=dev)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 255, (b, s, s, 3), np.uint8)).to(dev)
    c0 = torch.zeros((), dtype=torch.uint8, device=dev)

    def scan_over(model, nms=False):
        @torch.inference_mode()
        def prog(images_u8, c0):
            c, total = c0, 0
            for _ in range(k):
                pred = model(unit_pixels((images_u8 + c).permute(0, 3, 1, 2), torch.bfloat16))
                if nms:
                    det, _, num = non_max_suppression(pred.float(), conf_thres=0.4,
                                                      iou_thres=0.45, max_det=300,
                                                      pre_nms_topk=256)
                    pred = det * 1e-9 + num[:, None, None]
                c, total = c + 1, total + pred.float().sum() * 1e-9
            return total
        return prog

    out = {"platform": dev.type,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "protocol": f"K={k} chained steps in one timed call (CUDA events on the card)",
           "bf16_ms": timed_scan(scan_over(inferer.model), k, x, c0) * 1e3}
    models = {}
    for name, extra, flags in CUTS:
        models[name] = build_int8_model(inferer.model, amax, table,
                                        skip_substrings=tuple(DEFAULT_SKIP_SUBSTRINGS) + extra,
                                        **flags)
        out[f"{name}_ms"] = timed_scan(scan_over(models[name]), k, x, c0) * 1e3
    out["bf16_nms_ms"] = timed_scan(scan_over(inferer.model, nms=True), k, x, c0) * 1e3
    out["int8_full_nms_ms"] = timed_scan(scan_over(models["int8_full"], nms=True), k, x, c0) * 1e3
    if not args.skip_chain_micro:
        out.update(chain_micro(b, s, k, dev))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
