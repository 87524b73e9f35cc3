"""LP-head distillation proof: the student trained alone against the student
trained with --distill (mirrors tools/distill_proof.py of the JAX package).

  A. train the student config from scratch           -> baseline val metrics
  B. train it again with --distill from a teacher    -> distilled val metrics
  C. eval both best checkpoints with the eval CLI    -> RESULTS.md table

Both runs share data, epochs, seed and schedule; the only difference is the
distillation term. Stages are subprocesses over this package's CLIs.

Example (synthetic data, a teacher trained by either package):
  python -m yololp_tpu_torch.tools.distill_proof --data runs/data/synth24k.yaml \\
      --teacher-ckpt runs/train/yololps_synth24k/weights/best_ckpt.msgpack \\
      --epochs 120 --img-size 320 --batch-size 64
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

from yololp_tpu_torch.tools.repopt_qat_pipeline import cli, parse_eval, run

_CFG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs", "experiment")


def best_val_from_log(log_jsonl: str):
    """The best val/mAP record of a training log (the eval epochs)."""
    best = None
    with open(log_jsonl) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "val/mAP" in rec and (best is None or rec["val/mAP"] > best["val/mAP"]):
                best = rec
    return best


def results_lines(args, rows):
    """RESULTS.md lines in the JAX tool's layout."""
    lines = ["# LP distillation proof", "",
             f"student={osp.basename(args.student_conf)} teacher={args.teacher_ckpt}",
             f"data={args.data} img={args.img_size} b={args.batch_size} "
             f"epochs={args.epochs} seed={args.seed}", "",
             "| run | mAP | mAP50 | mAP75 | mAP50-95 | recall | best during train |",
             "|---|---|---|---|---|---|---|"]
    for name, r in rows.items():
        tb = r["train_best"]
        tb_s = f"{tb['val/mAP']:.4f} @e{tb['epoch']}" if tb else "n/a"
        lines.append(f"| {name} | {r['mAP']:.4f} | {r['mAP50']:.4f} | {r['mAP75']:.4f} | "
                     f"{r['mAP50_95']:.4f} | {r['recall']:.4f} | {tb_s} |")
    delta = rows["distill"]["mAP"] - rows["baseline"]["mAP"]
    return lines + ["", f"distill - baseline mAP delta: {delta:+.4f}"]


def main(argv=None):
    p = argparse.ArgumentParser("LP distillation proof (PyTorch/CUDA)")
    p.add_argument("--data", required=True, help="dataset yaml")
    p.add_argument("--student-conf", default=osp.join(_CFG_DIR, "yololpn_synth.py"))
    p.add_argument("--teacher-conf", default=osp.join(_CFG_DIR, "yololps_synth.py"))
    p.add_argument("--teacher-ckpt", required=True)
    p.add_argument("--img-size", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--eval-interval", type=int, default=10)
    p.add_argument("--heavy-eval-range", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache-device", action="store_true", default=True)
    p.add_argument("--no-cache-device", dest="cache_device", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="runs/distill_proof")
    p.add_argument("--skip-baseline", action="store_true", help="reuse an existing baseline run")
    args = p.parse_args(argv)

    if not osp.isfile(args.teacher_ckpt):
        raise SystemExit(f"teacher checkpoint not found: {args.teacher_ckpt}")
    out = osp.abspath(args.output_dir)
    os.makedirs(out, exist_ok=True)
    train = cli("train")
    common = ["--data-path", args.data, "--conf-file", args.student_conf,
              "--img-size", str(args.img_size), "--batch-size", str(args.batch_size),
              "--epochs", str(args.epochs), "--eval-interval", str(args.eval_interval),
              "--heavy-eval-range", str(args.heavy_eval_range), "--stop_aug_last_n_epoch", "0",
              "--seed", str(args.seed), "--device", args.device, "--output-dir", out,
              "--workers", "0"] + (["--cache-device"] if args.cache_device else [])

    base_dir, kd_dir = osp.join(out, "baseline"), osp.join(out, "distill")
    if not (args.skip_baseline and osp.isfile(osp.join(base_dir, "weights", "best_ckpt.msgpack"))):
        run(train + common + ["--name", "baseline"], osp.join(out, "baseline.log"))
    run(train + common + ["--name", "distill", "--distill", "--teacher-ckpt", args.teacher_ckpt,
                          "--teacher-conf", args.teacher_conf], osp.join(out, "distill.log"))

    eval_common = ["--data", args.data, "--conf-file", args.student_conf, "--img-size",
                   str(args.img_size), "--batch-size", str(args.batch_size), "--device",
                   args.device]
    rows = {}
    for name, d in (("baseline", base_dir), ("distill", kd_dir)):
        ckpt = osp.join(d, "weights", "best_ckpt.msgpack")
        if not osp.isfile(ckpt):
            ckpt = osp.join(d, "weights", "last_ckpt.msgpack")
        log = osp.join(out, f"eval_{name}.log")
        run(cli("eval") + eval_common + ["--weights", ckpt, "--save-dir",
                                         osp.join(out, f"val_{name}")], log)
        rows[name] = parse_eval(log)
        rows[name]["train_best"] = best_val_from_log(osp.join(d, "train_log.jsonl"))

    lines = results_lines(args, rows)
    results = osp.join(out, "RESULTS.md")
    with open(results, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwritten: {results}")


if __name__ == "__main__":
    main()
