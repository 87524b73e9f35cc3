"""Evaluation CLI (mirrors tools/eval.py of the JAX package).

Prints the LP metric (AP per IoU bucket, mAP/mAP50/mAP75/mAP50-95, recall)
and the speed report (pre / infer / post ms per image).

  python -m yololp_tpu_torch.tools.eval --data data.yaml --weights best_ckpt.msgpack
  python -m yololp_tpu_torch.tools.eval --device cpu --synthetic-data <root> \\
      --conf-file yololpn --img-size 64 --batch-size 4 --workers 0

`--synthetic-data` takes a root written by the JAX package's
`data.synthetic.make_synthetic_dataset`. True int8: add `--int8 --calib-pt
amax.json --conv-impl {conv,dots,pallas}`. `--mesh N` splits every batch
over N cards, one model replica each (parallel/infer.py; with --device cpu,
N replicas on the CPU); with --int8 the int8 program runs on one card, as
the JAX CLI's run_eval does with a given run_fn.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

def get_args_parser():
    p = argparse.ArgumentParser("YOLO-LP evaluation (PyTorch/CUDA)", add_help=True)
    p.add_argument("--data", type=str, default=None, help="dataset yaml")
    p.add_argument("--weights", type=str, default=None,
                   help="checkpoint path (.msgpack); omit for the seeded random init")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--task", default="val", choices=["val", "test", "speed"])
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--half", action="store_true", default=True)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--test_load_size", type=int, default=None)
    p.add_argument("--letterbox_return_int", action="store_true")
    p.add_argument("--rect", action="store_true",
                   help="rect-batched val (aspect-sorted batches, pad 0.5, shapes "
                        "rounded up to 64 px)")
    p.add_argument("--mesh", type=int, default=0,
                   help="split each batch over this many cards (0 or 1: one device)")
    p.add_argument("--nms-selector", default="topk", choices=["topk", "approx"])
    p.add_argument("--native-preproc", action="store_true",
                   help="decode and letterbox each batch with the native batch decoder "
                        "(data/native.py; needs OpenCV or cv2); square val protocol only")
    p.add_argument("--synthetic-data", type=str, default=None,
                   help="path to a make_synthetic_dataset root (smoke/demo)")
    p.add_argument("--int8", action="store_true",
                   help="execute calibrated convs in int8 (needs --calib-pt)")
    p.add_argument("--calib-pt", type=str, default=None,
                   help="calibration amax json (from either package)")
    p.add_argument("--conv-impl", default="conv", choices=["conv", "dots", "pallas"],
                   help="int8 plan: 'pallas' runs RepBlock chains fused with a float exit; "
                        "'conv' and 'dots' hand chain exits off in int8")
    p.add_argument("--save-json", action="store_true",
                   help="also emit COCO-format prediction/annotation jsons "
                        "(+ COCOeval when pycocotools is installed)")
    p.add_argument("--save-dir", type=str, default="runs/val/exp")
    p.add_argument("--eval-params", type=str, default=None,
                   help="experiment config with eval_params overrides")
    p.add_argument("--model-name", type=str, default="default",
                   help="key into eval_params")
    return p


def apply_eval_params(args):
    """Per-model eval-knob overrides from an experiment config."""
    if not args.eval_params:
        return args
    from yololp_tpu_torch.utils.config import Config

    cfg = Config.fromfile(args.eval_params)
    params = cfg.get("eval_params") or {}
    entry = params.get(args.model_name) or params.get("default") or {}
    for key in ("img_size", "test_load_size", "letterbox_return_int", "conf_thres",
                "iou_thres"):
        if key in entry:
            v = entry[key]
            # a 2-list is [train_override, standalone]
            if isinstance(v, (list, tuple)) and len(v) == 2:
                v = v[1]
            setattr(args, key, v)
    return args


def write_coco_jsons(save_dir, img_size, preds, targets, paths):
    """COCO prediction and annotation jsons, in the same (letterboxed)
    coordinates; returns their paths."""
    from yololp_tpu_torch.utils.coco import predictions_to_coco_json

    pred_json = osp.join(save_dir, "predictions.json")
    predictions_to_coco_json(dict(zip(paths, preds)), pred_json)
    anno = {"categories": [{"id": i, "name": str(i), "supercategory": ""} for i in range(31)],
            "images": [], "annotations": []}
    ann_id = 0
    for path, tgt in zip(paths, targets):
        img_id = osp.splitext(osp.basename(path))[0]
        anno["images"].append({"file_name": osp.basename(path), "id": img_id,
                               "width": img_size, "height": img_size})
        for row in tgt:
            x1, y1, x2, y2 = (float(v) for v in row[8:12])
            anno["annotations"].append(
                {"area": (x2 - x1) * (y2 - y1), "bbox": [x1, y1, x2 - x1, y2 - y1],
                 "category_id": int(row[0]), "id": ann_id, "image_id": img_id,
                 "iscrowd": 0, "segmentation": []})
            ann_id += 1
    anno_json = osp.join(save_dir, "instances_val.json")
    os.makedirs(save_dir, exist_ok=True)
    with open(anno_json, "w") as f:
        json.dump(anno, f)
    return pred_json, anno_json


def print_report(results, speed):
    mAP, mAP50, mAP75, mAP5095, recall, mAP_list, recall_list = results
    print("AP per IoU bucket [0.50..0.95]:")
    for i, (ap, rc) in enumerate(zip(mAP_list, recall_list)):
        ap_s = "  n/a " if ap == -1 else f"{ap:.4f}"  # -1 = empty bucket
        print(f"  IoU {0.5 + i * 0.05:.2f}: AP={ap_s} recall={rc:.4f}")
    print(f"mAP={mAP:.4f} mAP50={mAP50:.4f} mAP75={mAP75:.4f} "
          f"mAP50-95={mAP5095:.4f} recall={recall:.4f}")
    print(f"speed per image: pre {speed['pre_ms']:.2f} ms, "
          f"infer {speed['infer_ms']:.2f} ms, post {speed['post_ms']:.2f} ms")


def main(args=None):
    parser = get_args_parser()
    args = parser.parse_args(args)
    if args.int8 and not args.calib_pt:
        parser.error("--int8 requires --calib-pt")
    args = apply_eval_params(args)
    if args.task == "speed":  # the speed task's threshold
        args.conf_thres = max(args.conf_thres, 0.4)

    import torch

    from yololp_tpu_torch.core.evaler import run_eval
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.data.vocab import load_dataset_yaml

    if args.synthetic_data:
        data_dict = {"val": osp.join(args.synthetic_data, "images", "val"),
                     "npro": 31, "nalp": 24, "nads": 37}
    else:
        if not args.data:
            parser.error("--data or --synthetic-data required")
        data_dict = load_dataset_yaml(args.data)

    eval_hyp = {}
    if args.test_load_size:
        eval_hyp["test_load_size"] = args.test_load_size
    if args.letterbox_return_int:
        eval_hyp["letterbox_return_int"] = True

    # the deploy model in the compute dtype on the device, as the inferer builds it
    inferer = Inferer(None, args.weights, args.conf_file, img_size=args.img_size,
                      half=args.half, conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                      npro=int(data_dict.get("npro", 31)), nalp=int(data_dict.get("nalp", 24)),
                      nads=int(data_dict.get("nads", 37)), device=args.device)

    mesh = None
    if args.mesh > 1:
        from yololp_tpu_torch.parallel.infer import infer_mesh

        mesh = infer_mesh(args.mesh, args.device)

    run_fn = None
    if args.int8:
        from yololp_tpu_torch.quant.int8_infer import make_int8_infer_fn
        from yololp_tpu_torch.quant.quantize import load_amax

        int8_run = make_int8_infer_fn(
            inferer.model, inferer.variables, load_amax(args.calib_pt),
            conf_thres=args.conf_thres, iou_thres=args.iou_thres,
            candidate_selector=args.nms_selector, conv_impl=args.conv_impl, device=args.device)

        def run_fn(_vars, images):
            return int8_run(images)

    with torch.inference_mode():
        out = run_eval(
            inferer.model, None, data_dict, batch_size=args.batch_size,
            img_size=args.img_size, conf_thres=args.conf_thres, iou_thres=args.iou_thres,
            half=args.half, workers=args.workers, eval_hyp=eval_hyp,
            task="val" if args.task == "speed" else args.task,
            return_preds=args.save_json, run_fn=run_fn, rect=args.rect,
            native=args.native_preproc, mesh=mesh, nms_selector=args.nms_selector,
            device=args.device)
    if args.save_json:
        results, speed, (preds, targets, paths) = out
        from yololp_tpu_torch.utils.coco import cocoeval_if_available

        pred_json, anno_json = write_coco_jsons(args.save_dir, args.img_size, preds, targets,
                                                paths)
        print(f"COCO jsons: {pred_json} + {anno_json}")
        stats = cocoeval_if_available(anno_json, pred_json)
        if stats is not None:
            print("COCOeval mAP:", stats[0])
    else:
        results, speed = out
    print_report(results, speed)
    return results, speed


if __name__ == "__main__":
    main()
