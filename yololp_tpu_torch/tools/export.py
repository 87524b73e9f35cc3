"""Export CLI (mirrors tools/export.py of the JAX package).

Formats:
  pt2          a torch.export program (<out>.pt2) and its description
               (<out>.json); with --aoti also an AOTInductor package
               (<out>.aoti.pt2) for the native runner in deploy/aoti_cpp
  saved_model  refused: it needs TensorFlow, which is not installed

Example:
  python -m yololp_tpu_torch.tools.export --weights best_ckpt.msgpack \\
      --conf-file yololps --out model --batch-size 32 --aoti

The program runs on --device (cuda unless the CPU is asked for): its kernels
are that device's.
"""

from __future__ import annotations

import argparse


def get_args_parser():
    p = argparse.ArgumentParser("YOLO-LP export (PyTorch/CUDA)")
    p.add_argument("--weights", type=str, default=None,
                   help="checkpoint path (.msgpack); omit for the seeded init")
    p.add_argument("--conf-file", type=str, default="yololps")
    p.add_argument("--format", choices=["pt2", "saved_model"], default="pt2")
    p.add_argument("--out", type=str, required=True,
                   help="artifact path; <out>.pt2, <out>.json (and <out>.aoti.pt2)")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--end2end", action="store_true", default=True,
                   help="compile decode+NMS into the graph")
    p.add_argument("--no-end2end", dest="end2end", action="store_false")
    p.add_argument("--conf-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--half", action="store_true", default=True)
    p.add_argument("--fp32", dest="half", action="store_false")
    p.add_argument("--int8", action="store_true",
                   help="export an int8 engine: calibrated convs run int8 x int8 -> int32 in "
                        "csrc/int8_conv.cu (needs --calib-pt)")
    p.add_argument("--calib-pt", type=str, default=None,
                   help="calibration amax json (either package's)")
    p.add_argument("--aoti", action="store_true",
                   help="also compile an AOTInductor package for the native runner")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p


def main(args=None):
    parser = get_args_parser()
    args = parser.parse_args(args)
    if args.int8 and not args.calib_pt:
        parser.error("--int8 requires --calib-pt")
    if args.int8 and args.format != "pt2":
        parser.error("--int8 is pt2-only")

    from yololp_tpu_torch.export import export as ex

    if args.format == "saved_model":
        ex.export_saved_model()  # raises: TensorFlow is not installed
    paths = ex.export_pt2(
        args.conf_file, args.weights, args.out, batch=args.batch_size, img_size=args.img_size,
        end2end=args.end2end, conf_thres=args.conf_thres, iou_thres=args.iou_thres,
        max_det=args.max_det, half=args.half, calib_pt=args.calib_pt if args.int8 else None,
        aoti=args.aoti, device=args.device)
    print(f"torch.export program: {paths['pt2']} (+ {paths['json']}); load it with "
          f"torch.export.load(path).module() after importing yololp_tpu_torch.ops")
    if "aoti" in paths:
        print(f"AOTInductor package: {paths['aoti']}")
        print("Run it natively: runner=$(python -m yololp_tpu_torch.deploy.aoti_cpp) && "
              f"$runner --model {paths['aoti']} --bench 20 --batch {args.batch_size} "
              f"--size {args.img_size}   (or --image img.jpg where OpenCV was found)")
    return paths


if __name__ == "__main__":
    main()
