"""Training CLI (mirrors tools/train.py of the JAX package).

Examples:
  python -m yololp_tpu_torch.tools.train --conf-file yololps --data-path data/dataset.yaml
  python -m yololp_tpu_torch.tools.train --conf-file yololpn --synthetic-data --epochs 2 \\
      --img-size 64 --batch-size 4 --device cpu     # smoke run, no dataset
  # RepOpt: hyper-search, then the RealVGG net from its scales (a config
  # whose `scales` names the hyper-search checkpoint or a scales file)
  python -m yololp_tpu_torch.tools.train --conf-file repopt/yolov6n_hs ...
  python -m yololp_tpu_torch.tools.train --conf-file my_yolov6n_opt.py ...
  # distillation from a teacher checkpoint
  python -m yololp_tpu_torch.tools.train --conf-file yololpn --distill \\
      --teacher-ckpt runs/train/yololps/weights/best_ckpt.msgpack --teacher-conf yololps ...

One device, one process: `--device cuda` (the default) or `cpu`. Writes
last/best checkpoints and final_ckpt.msgpack under <output-dir>/<name>/weights
in the JAX package's msgpack format (either package loads them).
"""

from __future__ import annotations

import argparse
import os.path as osp


def get_args_parser():
    p = argparse.ArgumentParser("YOLO-LP training (PyTorch/CUDA)", add_help=True)
    p.add_argument("--data-path", type=str, default=None, help="dataset yaml")
    p.add_argument("--conf-file", type=str, default="yololps",
                   help="model config: built-in name or .py path")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--eval-interval", type=int, default=20)
    p.add_argument("--heavy-eval-range", type=int, default=50,
                   help="eval every epoch in the last N epochs")
    p.add_argument("--stop_aug_last_n_epoch", type=int, default=15)
    p.add_argument("--save_ckpt_on_last_n_epoch", type=int, default=0)
    p.add_argument("--save-every-epoch", action="store_true",
                   help="save last_ckpt every epoch (default: eval epochs only)")
    p.add_argument("--output-dir", default="./runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--resume", nargs="?", const=True, default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--approx-topk", action="store_true",
                   help="accepted for the JAX CLI's sake: the port's assigners always "
                        "take the exact top-k (a stable sort)")
    p.add_argument("--assigner", choices=["atss", "tal", "atss_tal"], default=None,
                   help="override the label assigner: atss, tal, or atss_tal (ATSS "
                        "warmup epochs, then task-aligned)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--data-parallel", action="store_true", default=True,
                   help="accepted; one device only (multi-GPU waits for ROADMAP A.13)")
    p.add_argument("--cache-device", action="store_true",
                   help="stage the whole dataset on the device and gather batches there "
                        "(no-augmentation runs only)")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   help="with --cache-device: run up to K consecutive epochs in one call "
                        "(chunks break at eval/ckpt epochs and assigner switches)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="generate a small synthetic dataset (smoke/demo)")
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--quant", action="store_true",
                   help="QAT training (requires a calib amax file)")
    p.add_argument("--calib", action="store_true",
                   help="with --quant: run PTQ calibration then exit")
    p.add_argument("--calib-pt", type=str, default=None,
                   help="calibration amax json for QAT (overrides cfg.qat)")
    p.add_argument("--distill", action="store_true",
                   help="LP knowledge distillation from --teacher-ckpt")
    p.add_argument("--teacher-ckpt", type=str, default=None,
                   help="teacher checkpoint (either package's msgpack)")
    p.add_argument("--teacher-conf", type=str, default=None,
                   help="teacher config (default: --conf-file)")
    return p


def main(args=None):
    parser = get_args_parser()
    args = parser.parse_args(args)
    if not (args.synthetic_data or args.data_path):
        parser.error("--data-path or --synthetic-data required")
    from yololp_tpu_torch.core.engine import Trainer
    from yololp_tpu_torch.data.vocab import load_dataset_yaml
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no card and not --device cpu: raise before any work
    cfg = (Config.fromfile(args.conf_file) if args.conf_file.endswith(".py")
           else Config.named(args.conf_file))
    if args.synthetic_data:
        from yololp_tpu_torch.data.synthetic import make_synthetic_dataset

        data_dict = make_synthetic_dataset(
            osp.join(args.output_dir, "synthetic_data"), n_train=args.synthetic_n,
            n_val=max(args.synthetic_n // 4, 4), img_size=args.img_size, seed=args.seed)
    else:
        data_dict = load_dataset_yaml(args.data_path)
    args.save_dir = osp.join(args.output_dir, args.name)

    trainer = Trainer(args, cfg, data_dict)
    resume_path = None
    if args.resume:
        resume_path = (args.resume if isinstance(args.resume, str)
                       else osp.join(args.save_dir, "weights", "last_ckpt.msgpack"))
    if args.quant and args.calib:
        if resume_path:
            trainer.resume(resume_path)
        return trainer.calibrate()
    best = trainer.train(resume_path=resume_path)
    print(f"Training done. best mAP={best:.4f}. Checkpoints in "
          f"{osp.join(args.save_dir, 'weights')}")
    return best


if __name__ == "__main__":
    main()
