"""Sectional inference profiler: where do the milliseconds go? (Counterpart
of tools/profile_sections.py.)

Times the deploy forward cumulatively by section (backbone, backbone+neck,
full forward, forward+NMS) in bf16 and, with --calib-pt, in true int8 (the
default plan of `build_int8_model`), plus the NMS alone on synthetic
logits. PyTorch runs eagerly, so a section is cut by calling the model's
`backbone`, `neck` and `detect` in turn and stopping: nothing downstream
runs. --stages adds cumulative cuts through the backbone's stages. The NMS
alone runs twice, as in the JAX tool: with its exact keep-mask
(nms_iters=0, the CUDA kernel on the card) and with the fixed bound of 16
update steps (nms_iters=16).

Protocol: utils/profiler.timed_scan (K chained steps in one timed call;
each step's input is offset by 1e-3 times the step count). Prints one line
a section and, last, the rows as one JSON object.

    python -m yololp_tpu_torch.tools.profile_sections --device cuda --calib-pt amax.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import timed_scan

STAGES = ("ERBlock_2", "ERBlock_3", "ERBlock_4", "ERBlock_5")


def backbone_upto(backbone, x, stage: str):
    """The backbone's stem and stages up to `stage` (its sppf included for
    ERBlock_5), as EfficientRep.forward runs them; 'stem' stops after the
    stem."""
    x = backbone.stem(x)
    if stage == "stem":
        return x
    for st in STAGES:
        x = getattr(backbone, f"{st}_rep")(getattr(backbone, f"{st}_down")(x))
        if st == "ERBlock_5":
            x = backbone.ERBlock_5_sppf(x)
        if st == stage:
            return x
    raise ValueError(f"no backbone stage {stage!r}")


def main(argv=None):
    p = argparse.ArgumentParser("YOLO-LP sectional profiler (PyTorch/CUDA)")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--weights", type=str, default=None,
                   help="checkpoint (random init when absent: timings do not depend "
                        "on the weights' values)")
    p.add_argument("--calib-pt", type=str, default=None,
                   help="amax json; int8 sections are skipped without it")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--conf-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--stages", action="store_true",
                   help="also time cumulative per-backbone-stage cuts")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: batch 2, 64 px, 2 steps (overrides those flags)")
    args = p.parse_args(argv)
    if args.small:
        args.batch_size, args.img_size, args.iters = 2, 64, 2
    dev = resolve_device(args.device)

    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.ops.nms import non_max_suppression

    b, s, k = args.batch_size, args.img_size, args.iters
    inferer = Inferer(".", args.weights, args.conf_file, img_size=s, half=True, device=dev)
    models = {"bf16": inferer.model}
    if args.calib_pt:
        from yololp_tpu_torch.quant.int8_infer import build_int8_model, quantize_kernels_int8
        from yololp_tpu_torch.quant.quantize import load_amax

        models["int8"] = build_int8_model(inferer.model, load_amax(args.calib_pt),
                                          quantize_kernels_int8(inferer.variables, device=dev))

    def nms(pred, nms_iters=0):
        return non_max_suppression(pred.float(), conf_thres=args.conf_thres,
                                   iou_thres=args.iou_thres, max_det=300, pre_nms_topk=256,
                                   nms_iters=nms_iters)

    rows = []

    def bench(fn, name, x0, step):
        @torch.inference_mode()
        def prog(p0, c0):
            c, total = c0, 0
            for _ in range(k):
                out = fn(p0 + c * step)
                total = total + sum(t.float().sum() * 1e-9 for t in
                                    (out if isinstance(out, (tuple, list)) else (out,)))
                c = c + 1
            return total

        dt = timed_scan(prog, k, x0, torch.zeros((), dtype=x0.dtype, device=dev))
        rows.append({"section": name, "ms_per_batch": dt * 1e3, "img_per_s": b / dt})
        print(f"{name:28s} {dt * 1e3:8.2f} ms/batch  {b / dt:8.0f} img/s", flush=True)

    rng0 = np.random.default_rng(0)
    x0 = (torch.from_numpy((rng0.normal(0, 0.3, (b, s, s, 3)) + 0.5).clip(0, 1))
          .to(dev, torch.bfloat16).permute(0, 3, 1, 2))  # NCHW view, channels_last
    step = 1e-3
    for tag, m in models.items():
        if args.stages:
            for st in ("stem",) + STAGES:
                bench(lambda x, m=m, st=st: backbone_upto(m.backbone, x, st), f"..{st} {tag}",
                      x0, step)
        bench(lambda x, m=m: m.backbone(x), f"backbone {tag}", x0, step)
        bench(lambda x, m=m: m.neck(m.backbone(x)), f"backbone+neck {tag}", x0, step)
        bench(lambda x, m=m: m(x), f"full fwd {tag}", x0, step)
        bench(lambda x, m=m: nms(m(x)), f"e2e fwd+nms {tag}", x0, step)

    # NMS alone on synthetic logits: the exact keep-mask, then the fixed bound
    n_anchors = (s // 8) ** 2 + (s // 16) ** 2 + (s // 32) ** 2
    pred = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (b, n_anchors, 290))
                            .astype(np.float32)).to(dev)
    for it in (0, 16):
        bench(lambda p_, it=it: nms(p_, it), f"nms alone (nms_iters={it})", pred, 1e-6)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "batch": b, "img_size": s, "iters": k, "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
