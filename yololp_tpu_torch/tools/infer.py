"""Inference CLI (mirrors tools/infer.py of the JAX package).

Example:
  python -m yololp_tpu_torch.tools.infer --source img.jpg --conf-file yololps \
      --weights best_ckpt.msgpack

True-int8 inference (calibrated convs in csrc/int8_conv.cu):
  python -m yololp_tpu_torch.tools.infer --source img.jpg --conf-file yololps \
      --int8 --calib-pt amax.json --conv-impl pallas

Writes label txts and annotated images (--not-save-img: txts only).
"""

from __future__ import annotations

import argparse
import os.path as osp


def get_args_parser():
    parser = argparse.ArgumentParser("YOLO-LP inference (PyTorch/CUDA)", add_help=True)
    parser.add_argument("--weights", type=str, default=None,
                        help="checkpoint path (.msgpack); omit for random init smoke run")
    parser.add_argument("--source", type=str, required=True,
                        help="image file / dir / glob / video")
    parser.add_argument("--conf-file", dest="conf_file", type=str, default="yololps",
                        help="model config: built-in name or .py path")
    parser.add_argument("--yaml", type=str, default=None,
                        help="dataset yaml (vocab); accepted and unused, as in the JAX CLI")
    parser.add_argument("--img-size", nargs="+", type=int, default=[640, 640])
    parser.add_argument("--conf-thres", type=float, default=0.4)
    parser.add_argument("--iou-thres", type=float, default=0.45)
    parser.add_argument("--max-det", type=int, default=1000)
    parser.add_argument("--nms-selector", default="topk", choices=["topk", "approx"])
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    parser.add_argument("--save-txt", action="store_true", default=True)
    parser.add_argument("--not-save-img", action="store_true")
    parser.add_argument("--project", default="runs/inference")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--half", action="store_true", default=True,
                        help="bf16 compute")
    parser.add_argument("--batch-size", type=int, default=1,
                        help=">1 enables the batched throughput path")
    parser.add_argument("--int8", action="store_true",
                        help="execute calibrated convs in int8 (csrc/int8_conv.cu)")
    parser.add_argument("--conv-impl", default="conv", choices=["conv", "dots", "pallas"],
                        help="int8 plan: 'pallas' runs RepBlock chains fused with a float "
                             "exit; 'conv' and 'dots' (one plan) hand chain exits off in int8")
    parser.add_argument("--calib-pt", type=str, default=None,
                        help="calibration amax json (required with --int8)")
    return parser


def main(args=None):
    parser = get_args_parser()
    args = parser.parse_args(args)
    if args.int8 and not args.calib_pt:
        parser.error("--int8 requires --calib-pt")

    from yololp_tpu_torch.core.inferer import Inferer

    img_size = args.img_size if len(args.img_size) == 2 else args.img_size * 2
    inferer = Inferer(args.source, args.weights, args.conf_file,
                      img_size=img_size, half=args.half,
                      conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                      max_det=args.max_det, nms_selector=args.nms_selector,
                      device=args.device)
    if args.int8:
        from yololp_tpu_torch.quant.quantize import load_amax

        inferer.use_int8(load_amax(args.calib_pt), conv_impl=args.conv_impl)
    save_dir = osp.join(args.project, args.name)
    if args.batch_size > 1:
        results = inferer.infer_batched(save_dir, batch_size=args.batch_size,
                                        save_txt=args.save_txt, save_img=not args.not_save_img)
    else:
        inferer.warmup()
        results = inferer.infer(save_dir, save_txt=args.save_txt,
                                save_img=not args.not_save_img)
    for path, dets in results:
        strings = [inferer.plate_text(d) for d in dets]
        print(f"{path}: {len(dets)} plate(s) {strings}")
    print(f"Average FPS: {inferer.fps_calc.accumulate():.1f}")
    print(f"Results saved to {save_dir}")


if __name__ == "__main__":
    main()
