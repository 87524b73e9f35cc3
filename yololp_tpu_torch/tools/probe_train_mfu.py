"""The train forward and backward across batch and image sizes, against the
card's bf16 peak (counterpart of tools/probe_train_mfu.py).

For each (batch, img) of the grid, the same model under autocast bf16 (fp32
parameters), K chained steps by utils/profiler.timed_scan (CUDA events):

  infer_fwd  the train graph in eval mode (BN on its running statistics)
  train_fwd  the train graph in train mode (BN on the batch's statistics)
  fwd_bwd    train_fwd and the gradient of sum(outputs) w.r.t. the
             parameters

with the flops of one step from utils/profiler.model_flops (convolutions
and matmuls, backward included) and the rate as a share of the card's dense
bf16 peak, 989 TFLOP/s (H100 SXM data sheet), in `mfu_pct_bf16_peak`. The
rows answer: infer_fwd against train_fwd, the cost of BN's statistics;
a variant across shapes, the card's use against the batch and image size;
fwd_bwd against train_fwd, the backward's efficiency. On the CPU the share
is not computed (None).

    python -m yololp_tpu_torch.tools.probe_train_mfu --device cuda
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import _leaves, model_flops, timed_scan

H100_BF16_PEAK = 989e12  # FLOP/s, dense bf16, H100 SXM data sheet


def _out_sum(tree) -> torch.Tensor:
    return sum(t.float().sum() for t in _leaves(tree))


def make_variants(model, k: int):
    """{name: (one_step(images, c), scan(images, c0))} of the three programs."""
    params = [p for p in model.parameters() if p.requires_grad]

    def x_of(images, c):
        from yololp_tpu_torch.ops.division import unit_pixels

        x = unit_pixels((images + c).permute(0, 3, 1, 2), torch.float32)
        return x.contiguous() if x.device.type == "cpu" else x

    def fwd(images, c, train):
        model.train(train)
        with torch.autocast(images.device.type, dtype=torch.bfloat16):
            return model(x_of(images, c))

    def infer_fwd(images, c):
        with torch.no_grad():
            return _out_sum(fwd(images, c, False)) * 1e-9

    def train_fwd(images, c):
        with torch.no_grad():
            return _out_sum(fwd(images, c, True)) * 1e-9

    def fwd_bwd(images, c):
        g = torch.autograd.grad(_out_sum(fwd(images, c, True)), params, allow_unused=True)
        return sum(t.sum() for t in g if t is not None) * 1e-9

    def scan_of(one):
        def scan(images, c0):
            return sum(one(images, c0 + i) for i in range(k))
        return scan

    return {name: (one, scan_of(one)) for name, one in
            (("infer_fwd", infer_fwd), ("train_fwd", train_fwd), ("fwd_bwd", fwd_bwd))}


def main(argv=None):
    p = argparse.ArgumentParser("train MFU attribution probe")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--shapes", type=str, default="48x448,128x448,32x640,128x640",
                   help="comma list of BxS")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: shapes 1x64,2x64, 2 steps (overrides those flags)")
    args = p.parse_args(argv)
    if args.small:
        args.shapes, args.iters = "1x64,2x64", 2
    dev = resolve_device(args.device)

    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.utils.config import Config

    k = args.iters
    cfg = (Config.fromfile(args.conf_file) if args.conf_file.endswith(".py")
           else Config.named(args.conf_file))
    model = build_model(cfg, seed=0, device=dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    variants = make_variants(model, k)
    c0 = torch.zeros((), dtype=torch.uint8, device=dev)
    rows = []
    for spec in args.shapes.split(","):
        b, s = (int(v) for v in spec.split("x"))
        images = torch.from_numpy(
            np.random.default_rng(0).integers(0, 255, (b, s, s, 3), np.uint8)).to(dev)
        for name, (one, scan) in variants.items():
            row = {"batch": b, "img": s, "variant": name}
            try:
                flops = model_flops(one, images, 3)["flops"]
                sec = timed_scan(scan, k, images, c0)
                rate = flops / sec
                row.update(ms=sec * 1e3, tflop=flops / 1e12, tflop_per_s=rate / 1e12,
                           mfu_pct_bf16_peak=(100 * rate / H100_BF16_PEAK
                                              if dev.type == "cuda" else None))
            except torch.cuda.OutOfMemoryError as e:  # a large shape: record and go on
                row["error"] = f"{type(e).__name__}: {e}"[:200]
                torch.cuda.empty_cache()
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = {"platform": dev.type,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "protocol": f"K={k} chained steps in one timed call (CUDA events on the card); "
                       "flops of one step by utils/profiler.model_flops; peak 989 TFLOP/s "
                       "dense bf16 (H100 SXM data sheet)",
           "rows": rows}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
