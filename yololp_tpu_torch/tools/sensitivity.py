"""Per-layer quantization sensitivity analysis (mirrors tools/sensitivity.py
of the JAX package; the reference's
tools/partial_quantization/sensitivity_analyse.py).

Quantizes ONE conv at a time (its input fake-quantized at the calibrated
amax, its kernel per output channel) and measures the LP-metric mAP drop on
a val subset, ranking the convs by it. The most sensitive go into
cfg.ptq/qat sensitive_layers_list for partial quantization.

Usage:
  python -m yololp_tpu_torch.tools.sensitivity --weights best.msgpack --conf-file yololps \\
      --data data/dataset.yaml --calib-pt calib_amax.json --max-images 128

The model computes in bf16 on the card (the JAX tool's dtype) and in fp32 on
the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp


def get_args_parser():
    p = argparse.ArgumentParser("quantization sensitivity analysis (PyTorch/CUDA)")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--synthetic-data", type=str, default=None)
    p.add_argument("--calib-pt", type=str, required=True)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-images", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--out", default="sensitivity.json")
    return p


def analyse(model, amax, ev, batches):
    """(baseline mAP, fully-quantized mAP, [(conv path, mAP drop)] ranked)
    of the deploy `model` (on the evaler's device, in its compute dtype) over the
    loader `batches` through Evaler `ev`, one conv of `amax` quantized at a
    time."""
    import torch

    from yololp_tpu_torch.ops.nms import non_max_suppression
    from yololp_tpu_torch.quant.quantize import (_image_tensor, model_device_dtype,
                                                 quantize_weights, quantized_apply)

    dev, dtype = model_device_dtype(model)

    def run_variant(target_layer):
        """target_layer None: the float baseline; '__all__': every conv
        quantized; else that conv alone."""
        if target_layer is None:
            run = ev.make_infer_fn(model)
        else:
            if target_layer == "__all__":
                sub_amax, skip = amax, ("proj_conv",)
            else:
                sub_amax = {target_layer: amax[target_layer]}
                skip = tuple(k.rsplit("/", 1)[0] for k in amax if k != target_layer)
            qmodel = quantize_weights(model, skip_substrings=skip)

            @torch.inference_mode()
            def run(images_u8):
                pred = quantized_apply(qmodel, _image_tensor(images_u8, dev, dtype), sub_amax)
                return non_max_suppression(pred.float(), conf_thres=ev.conf_thres,
                                           iou_thres=ev.iou_thres, max_det=ev.max_det)

        preds, targets = ev.predict(run, batches)
        return float(ev.eval(preds, targets)[0])

    base = run_variant(None)
    full = run_variant("__all__")
    print(f"baseline mAP {base:.4f} | fully-quantized mAP {full:.4f}")
    results = {}
    for i, layer in enumerate(sorted(amax)):
        m = run_variant(layer)
        results[layer] = base - m
        print(f"[{i + 1}/{len(amax)}] {layer}: mAP drop {base - m:+.4f}")
    return base, full, sorted(results.items(), key=lambda kv: -kv[1])


def main(args=None):
    args = get_args_parser().parse_args(args)

    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.data.vocab import load_dataset_yaml
    from yololp_tpu_torch.quant.quantize import load_amax
    from yololp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.synthetic_data:
        data_dict = {"val": osp.join(args.synthetic_data, "images", "val"),
                     "npro": 31, "nalp": 24, "nads": 37}
    else:
        data_dict = load_dataset_yaml(args.data)

    # the deploy model: the checkpoint's EMA, else seeded random weights
    inferer = Inferer(None, args.weights, args.conf_file, img_size=args.img_size,
                      half=dev.type == "cuda", npro=int(data_dict.get("npro", 31)),
                      nalp=int(data_dict.get("nalp", 24)), nads=int(data_dict.get("nads", 37)),
                      device=args.device)
    amax = load_amax(args.calib_pt)
    ev = Evaler(data_dict, args.batch_size, args.img_size, device=args.device)
    loader, _ = ev.init_data("val")

    # a bounded subset of batches, so that every variant sees the same data
    batches = []
    seen = 0
    for item in loader:
        batches.append(item)
        seen += len(item[0])
        if seen >= args.max_images:
            break

    base, full, ranked = analyse(inferer.model, amax, ev, batches)
    with open(args.out, "w") as f:
        json.dump({"baseline_mAP": base, "full_quant_mAP": full, "drops": dict(ranked)}, f,
                  indent=1)
    print(f"ranked sensitivity written to {args.out}; top-5:")
    for k, v in ranked[:5]:
        print(f"  {k}: {v:+.4f}")
    return ranked


if __name__ == "__main__":
    main()
