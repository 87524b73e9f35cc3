"""Weight-transplant parity harness (mirrors tools/transplant.py of the JAX
package).

Maps a checkpoint (a train-format flax-layout tree, written by either
package) onto the reference YOLOv6 torch Model through
utils/transplant.py, optionally saves the converted state dict, and with
`--data` runs the reference's own evaluator (its loader, NMS and LP metric)
beside this package's `run_eval` on the same val images, printing the
metrics side by side: same weights, same metrics, end to end.

`--data` needs the reference tree, which is not shipped: name it with
`--reference-dir` or the YOLOLP_REFERENCE_DIR environment variable (there
is no default); the conversion alone (`--out`) does not. Shims for the reference
tree: pycocotools is stubbed (only its COCO-json path needs it),
torchvision.ops.nms is replaced with an exact greedy NMS where torchvision
is absent, and the reference dataset's plate generators (which need font
assets the tree lacks, and are never used at val) are stubbed.

Usage:
  python -m yololp_tpu_torch.tools.transplant --weights best_ckpt.msgpack \\
      --conf-file yololp_tpu_torch/configs/experiment/yololps_synth.py \\
      --data data.yaml --reference-dir path/to/YOLOv6 --img-size 320 --max-images 256 \\
      [--out sd.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import tempfile
import types

from yololp_tpu_torch.utils.transplant import resolve_reference_dir

METRIC_NAMES = ["mAP", "mAP50", "mAP75", "mAP50_95", "recall"]
MATRIX_LABELS = ["our model+NMS, our metric", "ref model+NMS, ref metric",
                 "our model+NMS, ref metric", "ref model+NMS, our metric"]


def install_reference_shims(reference_dir=None):
    """Make the reference tree (`resolve_reference_dir`) importable:
    pycocotools and, where absent, torchvision stubs."""
    reference_dir = resolve_reference_dir(reference_dir)
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)

    if "pycocotools" not in sys.modules:
        pc = types.ModuleType("pycocotools")
        pc.coco = types.ModuleType("pycocotools.coco")
        pc.cocoeval = types.ModuleType("pycocotools.cocoeval")
        pc.coco.COCO = object
        pc.cocoeval.COCOeval = object
        sys.modules["pycocotools"] = pc
        sys.modules["pycocotools.coco"] = pc.coco
        sys.modules["pycocotools.cocoeval"] = pc.cocoeval

    try:
        import torchvision  # noqa: F401
    except ImportError:
        import torch

        def _greedy_nms(boxes, scores, iou_threshold):
            """Exact greedy NMS, the semantics of torchvision.ops.nms."""
            order = scores.argsort(descending=True)
            keep = []
            while order.numel() > 0:
                i = order[0]
                keep.append(i)
                if order.numel() == 1:
                    break
                rest = order[1:]
                b1, b2 = boxes[i], boxes[rest]
                lt = torch.max(b1[:2], b2[:, :2])
                rb = torch.min(b1[2:], b2[:, 2:])
                inter = (rb - lt).clamp(min=0).prod(-1)
                a1 = (b1[2:] - b1[:2]).clamp(min=0).prod(-1)
                a2 = (b2[:, 2:] - b2[:, :2]).clamp(min=0).prod(-1)
                iou = inter / (a1 + a2 - inter + 1e-12)
                order = rest[iou <= iou_threshold]
            return torch.stack(keep) if keep else torch.zeros(0, dtype=torch.long)

        tv = types.ModuleType("torchvision")
        tv.ops = types.ModuleType("torchvision.ops")
        tv.ops.nms = _greedy_nms
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.ops"] = tv.ops


def patch_reference_generators():
    """The reference TrainValDataset always constructs its plate generators,
    which need font assets missing from its tree; val never uses them."""
    import yolov6.data.datasets as ds

    class _NoGen:
        def __init__(self, *a, **k):
            pass

    ds.Blue_Gen = ds.Green_S_Gen = ds.Yel_S_Gen = ds.Green_B_Gen = _NoGen
    ds.generate = _NoGen


def make_subset(data_yaml: str, n: int, workdir: str):
    """Symlink the first n val images and labels into a dataset under
    `workdir` and return a data dict pointing at it (both evaluators see the
    same files), with its image dir."""
    import yaml

    with open(data_yaml) as f:
        data = yaml.safe_load(f)
    src_img = data["val"]
    if n <= 0:
        return data, src_img
    src_lbl = src_img.replace("/images/", "/labels/")
    img_dir = osp.join(workdir, "images", "val")
    lbl_dir = osp.join(workdir, "labels", "val")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    for name in sorted(os.listdir(src_img))[:n]:
        # absolute targets: a relative target would dangle from workdir
        os.symlink(osp.abspath(osp.join(src_img, name)), osp.join(img_dir, name))
        lbl = osp.splitext(name)[0] + ".txt"
        if osp.exists(osp.join(src_lbl, lbl)):
            os.symlink(osp.abspath(osp.join(src_lbl, lbl)), osp.join(lbl_dir, lbl))
    sub = dict(data)
    sub["val"] = img_dir
    return sub, img_dir


def _reference_model(state_dict, config, reference_dir):
    from yololp_tpu_torch.utils.transplant import build_reference_model, load_into_reference

    model = build_reference_model(config, reference_dir=reference_dir)
    load_into_reference(model, state_dict)
    return model.float().eval()


def reference_eval(state_dict, config, data, img_size, batch_size, conf_thres, iou_thres,
                   reference_dir=None):
    """The reference Evaler end to end (its loader, NMS and LP metric) on the
    transplanted model, on the CPU. Returns its metric list."""
    import torch

    install_reference_shims(reference_dir)
    patch_reference_generators()
    from yolov6.core.evaler import Evaler as RefEvaler

    model = _reference_model(state_dict, config, reference_dir)
    data = dict(data)
    data.setdefault("names", ["plate"])
    ev = RefEvaler(data, batch_size=batch_size, img_size=img_size, conf_thres=conf_thres,
                   iou_thres=iou_thres, device=torch.device("cpu"), half=False,
                   test_load_size=img_size)
    ev.stride = 32
    loader = ev.init_data(None, "val")
    with torch.no_grad():
        preds, targets, _, _ = ev.predict(model, loader, "val")
    return ev.eval(preds, targets, model, "val")


def _our_model(variables, config, img_size, device):
    """The fused deploy model of a train-format tree, fp32, on `device`."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.layers.fuse import fuse_state_dict
    from yololp_tpu_torch.utils.convert import jax_to_state_dict

    weights = fuse_state_dict(jax_to_state_dict(variables))
    return Inferer(None, weights, config, img_size=img_size, half=False, device=device).model


def our_eval(variables, config, data, img_size, batch_size, conf_thres, iou_thres, rect,
             device="cuda"):
    """This package's run_eval on the fused fp32 model. Returns its metric
    list."""
    from yololp_tpu_torch.core.evaler import run_eval

    model = _our_model(variables, config, img_size, device)
    results, _speed = run_eval(model, None, data, batch_size=batch_size, img_size=img_size,
                               conf_thres=conf_thres, iou_thres=iou_thres, half=False,
                               eval_hyp={"test_load_size": img_size}, rect=rect, device=device)
    return results


def shared_batch_eval(variables, state_dict, config, data, img_size, batch_size, conf_thres,
                      iou_thres, device="cuda", reference_dir=None):
    """Loader-controlled parity: both models take the same letterboxed
    batches (this package's rect val loader), then each framework's NMS and
    metric score its own predictions and the other's. Loader pixel
    differences are excluded by construction. Returns the four metric lists
    in MATRIX_LABELS' order."""
    import numpy as np
    import torch

    install_reference_shims(reference_dir)
    from yolov6.utils.nms import non_max_suppression as ref_nms

    from yololp_tpu_torch.core.evaler import Evaler

    model = _our_model(variables, config, img_size, device)
    tmodel = _reference_model(state_dict, config, reference_dir)
    ev = Evaler(data, batch_size, img_size, conf_thres, iou_thres, half=False,
                eval_hyp={"test_load_size": img_size}, device=device)
    loader, _ = ev.init_data("val", rect=True)
    our_preds, our_targets = ev.predict(ev.make_infer_fn(model), loader)

    ref_preds = []
    with torch.no_grad():
        for imgs, _labels, _masks, _paths, _shapes in loader:
            x = torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))).float() / 255
            dets = ref_nms(tmodel(x)[0], conf_thres, iou_thres, multi_label=True)
            ref_preds.extend(d.numpy() for d in dets)
    assert len(ref_preds) == len(our_preds)

    def their_metric(preds, targets):
        from yolov6.core.evaler import Evaler as RefEvaler

        ev_ref = RefEvaler.__new__(RefEvaler)
        ev_ref.speed_result = torch.zeros(4)  # eval() always reports speed
        tp = [[torch.from_numpy(np.asarray(p, np.float32)) for p in preds]]
        tt = [[torch.from_numpy(np.asarray(t, np.float32)) for t in targets]]
        return ev_ref.eval(tp, tt, None, "val")

    return (ev.eval(our_preds, our_targets), their_metric(ref_preds, our_targets),
            their_metric(our_preds, our_targets), ev.eval(ref_preds, our_targets))


def _print_matrix(rows):
    print("\n=== loader-controlled 4-way parity matrix ===")
    for label, row in zip(MATRIX_LABELS, rows):
        vals = {k: round(float(v), 4) for k, v in zip(METRIC_NAMES, row[:5])}
        print(f"  {label:28s} {vals}")


def get_args_parser():
    p = argparse.ArgumentParser("weight-transplant parity harness (PyTorch/CUDA)")
    p.add_argument("--weights", required=True, help="a train-format msgpack checkpoint")
    p.add_argument("--conf-file", required=True)
    p.add_argument("--out", default=None, help="save the torch state_dict here")
    p.add_argument("--data", default=None,
                   help="dataset yaml: compare the reference's evaluator with this package's "
                        "(needs the reference tree: --reference-dir)")
    p.add_argument("--img-size", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--max-images", type=int, default=256,
                   help="evaluate on the first N val images (0 = all)")
    p.add_argument("--rect", action="store_true",
                   help="kept for the JAX CLI's flags: this package's side always runs the rect "
                        "val protocol, as the reference does")
    p.add_argument("--skip-ours", action="store_true")
    p.add_argument("--shared-batches", action="store_true",
                   help="also run the loader-controlled 4-way parity matrix (both models on "
                        "identical letterboxed batches)")
    p.add_argument("--only-shared", action="store_true",
                   help="run only the 4-way shared-batch matrix")
    p.add_argument("--device", default="cuda",
                   help="this package's evaluator: cuda, cuda:N or cpu (the reference side "
                        "runs on the CPU)")
    p.add_argument("--reference-dir", default=None,
                   help="the reference YOLOv6 tree, which --data needs (no default: else "
                        "$YOLOLP_REFERENCE_DIR)")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    from yololp_tpu_torch.utils.checkpoint import load_checkpoint_raw
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.transplant import to_torch_state_dict

    if args.data:  # the evaluators touch the device: refuse before any work
        from yololp_tpu_torch.utils.device import resolve_device

        resolve_device(args.device)
        args.reference_dir = resolve_reference_dir(args.reference_dir)
    config = (Config.fromfile(args.conf_file) if args.conf_file.endswith(".py")
              else Config.named(args.conf_file))
    ckpt = load_checkpoint_raw(args.weights)
    if ckpt.get("format") == "deploy":
        raise SystemExit("transplant needs a train-format checkpoint (a deploy checkpoint has "
                         "fused branches the reference train model does not)")
    variables = ckpt.get("ema") or ckpt["variables"]
    sd = to_torch_state_dict(variables, reg_max=int(config.model.head.reg_max))
    print(f"converted {len(sd)} tensors from {args.weights}")

    if args.out:
        import torch

        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, args.out)
        print(f"saved torch state_dict -> {args.out}")

    if not args.data:
        return sd

    with tempfile.TemporaryDirectory() as tmp:
        data, _ = make_subset(args.data, args.max_images, tmp)
        common = (config, data, args.img_size, args.batch_size, args.conf_thres, args.iou_thres)
        if args.only_shared:
            _print_matrix(shared_batch_eval(variables, sd, *common, device=args.device,
                                            reference_dir=args.reference_dir))
            return sd

        print("\n=== reference evaler (torch CPU, its loader/NMS/metric) ===")
        ref = reference_eval(sd, *common, reference_dir=args.reference_dir)
        ref_row = {k: float(v) for k, v in zip(METRIC_NAMES, ref[:5])}
        print("reference:", {k: round(v, 4) for k, v in ref_row.items()})
        if args.skip_ours:
            return sd

        print("\n=== our evaler (yololp_tpu_torch, its loader/NMS/metric) ===")
        ours = our_eval(variables, *common, rect=True, device=args.device)
        our_row = {k: float(v) for k, v in zip(METRIC_NAMES, ours[:5])}
        print("ours:     ", {k: round(v, 4) for k, v in our_row.items()})
        print("\nside-by-side (ours - reference):")
        for k in METRIC_NAMES:
            print(f"  {k:10s} ours={our_row[k]:.4f} ref={ref_row[k]:.4f} "
                  f"delta={our_row[k] - ref_row[k]:+.4f}")
        if args.shared_batches:
            _print_matrix(shared_batch_eval(variables, sd, *common, device=args.device,
                                            reference_dir=args.reference_dir))
    return sd


if __name__ == "__main__":
    main()
