"""End-to-end RepOpt + quantization pipeline on one dataset (mirrors
tools/repopt_qat_pipeline.py of the JAX package).

  1. hyper-search train (CSLA / LinearAddBlock net)      -> scale vectors
  2. RepOpt train (RealVGG net, scales-reinit + masks)   -> float model
  3. PTQ calibration over train batches                  -> per-conv amax
  4. QAT finetune (straight-through fake-quant)          -> int8-ready model
  5. eval table: float / PTQ-int8 / QAT-int8 (true int8 in csrc/int8_conv.cu)

Each stage is a subprocess over this package's CLIs
(`python -m yololp_tpu_torch.tools.train` / `.eval`), so any stage can be
re-run by hand. Stage configs are generated into <output-dir>/configs from
this package's configs/repopt (the base config, data_aug zeroed for the
deterministic --cache-device path, then the stage's lines). Results land in
<output-dir>/RESULTS.md, in the JAX tool's layout.

Example (synthetic data):
  python -m yololp_tpu_torch.tools.repopt_qat_pipeline --data runs/data/synth24k.yaml \\
      --img-size 320 --batch-size 64 --hs-epochs 40 --opt-epochs 80 --qat-epochs 15
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import re
import subprocess
import sys

BASE_CFG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs", "repopt")

NO_AUG = """
data_aug = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, degrees=0.0, translate=0.0,
                scale=0.0, shear=0.0, flipud=0.0, fliplr=0.0, mosaic=0.0,
                mixup=0.0, generate=0.0, gen_paste=0.0)
"""


def write_stage_cfg(out_dir: str, name: str, base: str, extra: str = "") -> str:
    """Generated config = exec(base repopt config) + no-aug override + extra."""
    os.makedirs(osp.join(out_dir, "configs"), exist_ok=True)
    path = osp.join(out_dir, "configs", f"{name}.py")
    base_path = osp.join(BASE_CFG_DIR, base)
    body = (f"# generated by repopt_qat_pipeline from {base}\n"
            f"exec(open({base_path!r}).read())\n" + NO_AUG + extra)
    with open(path, "w") as f:
        f.write(body)
    return path


def run(cmd, log_path):
    print(f"\n>>> {' '.join(cmd)}\n    (log: {log_path})", flush=True)
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"stage failed rc={proc.returncode}:\n{tail}")


def parse_eval(log_path):
    """The summary metric line of an eval CLI log."""
    with open(log_path) as f:
        text = f.read()
    m = re.search(r"mAP=([\d.]+) mAP50=([\d.]+) mAP75=([\d.]+) "
                  r"mAP50-95=([\d.]+) recall=([\d.]+)", text)
    if not m:
        raise RuntimeError(f"no metric line in {log_path}")
    keys = ("mAP", "mAP50", "mAP75", "mAP50_95", "recall")
    return dict(zip(keys, (float(g) for g in m.groups())))


def cli(tool: str):
    """The command line of one of this package's CLIs."""
    return [sys.executable, "-m", f"yololp_tpu_torch.tools.{tool}"]


def main(argv=None):
    p = argparse.ArgumentParser("RepOpt + QAT pipeline (PyTorch/CUDA)")
    p.add_argument("--data", required=True, help="dataset yaml")
    p.add_argument("--model", default="yolov6n", choices=["yolov6n", "yolov6s", "yolov6_tiny"])
    p.add_argument("--img-size", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--hs-epochs", type=int, default=40)
    p.add_argument("--opt-epochs", type=int, default=80)
    p.add_argument("--qat-epochs", type=int, default=15)
    p.add_argument("--eval-interval", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache-device", action="store_true", default=True)
    p.add_argument("--no-cache-device", dest="cache_device", action="store_false")
    p.add_argument("--workers", type=int, default=0,
                   help="host loader workers (0: in-process; the cached train path never "
                        "touches the loader anyway)")
    p.add_argument("--output-dir", default="runs/repopt_pipeline")
    p.add_argument("--skip-hs", action="store_true",
                   help="reuse an existing hyper-search checkpoint")
    args = p.parse_args(argv)

    out = osp.abspath(args.output_dir)
    os.makedirs(out, exist_ok=True)
    train, evalp = cli("train"), cli("eval")
    common = ["--data-path", args.data, "--img-size", str(args.img_size),
              "--batch-size", str(args.batch_size), "--device", args.device,
              "--output-dir", out, "--eval-interval", str(args.eval_interval),
              "--stop_aug_last_n_epoch", "0", "--workers", str(args.workers)]
    cache = ["--cache-device"] if args.cache_device else []

    hs_ckpt = osp.join(out, "hs", "weights", "last_ckpt.msgpack")
    opt_last = osp.join(out, "opt", "weights", "last_ckpt.msgpack")
    calib_amax = osp.join(out, "calib", "weights", "calib_amax.json")
    calib_ckpt = osp.join(out, "calib", "weights", "calib_ckpt.msgpack")
    qat_last = osp.join(out, "qat", "weights", "last_ckpt.msgpack")

    hs_cfg, opt_cfg, qat_cfg = stage_configs(out, args.model, hs_ckpt, calib_amax)

    # 1. hyper-search
    if not (args.skip_hs and osp.isfile(hs_ckpt)):
        run(train + common + cache + ["--conf-file", hs_cfg, "--epochs", str(args.hs_epochs),
                                      "--name", "hs"], osp.join(out, "hs.log"))
    # 2. RepOpt train
    run(train + common + cache + ["--conf-file", opt_cfg, "--epochs", str(args.opt_epochs),
                                  "--name", "opt"], osp.join(out, "opt.log"))
    # 3. PTQ calibration (amax from train batches)
    run(train + common + ["--conf-file", qat_cfg, "--quant", "--calib", "--resume", opt_last,
                          "--name", "calib"], osp.join(out, "calib.log"))
    # 4. QAT finetune: calib_ckpt keeps the source epoch (opt_epochs - 1), so
    # the horizon is opt + qat epochs, qat_epochs of them run
    run(train + common + cache + ["--conf-file", qat_cfg, "--quant", "--calib-pt", calib_amax,
                                  "--resume", calib_ckpt, "--epochs",
                                  str(args.opt_epochs + args.qat_epochs), "--name", "qat"],
        osp.join(out, "qat.log"))

    # 5. eval table
    eval_common = ["--data", args.data, "--img-size", str(args.img_size),
                   "--batch-size", str(args.batch_size), "--device", args.device]
    rows = {}
    for name, log, extra in (
            ("RepOpt bf16", "eval_bf16.log", ["--conf-file", opt_cfg, "--weights", opt_last]),
            ("PTQ int8", "eval_ptq_int8.log", ["--conf-file", opt_cfg, "--weights", opt_last,
                                               "--int8", "--calib-pt", calib_amax]),
            ("QAT int8", "eval_qat_int8.log", ["--conf-file", qat_cfg, "--weights", qat_last,
                                               "--int8", "--calib-pt", calib_amax])):
        run(evalp + eval_common + extra, osp.join(out, log))
        rows[name] = parse_eval(osp.join(out, log))

    lines = ["# RepOpt + QAT pipeline results", "",
             f"model={args.model} data={args.data} img={args.img_size} b={args.batch_size} "
             f"epochs hs/opt/qat={args.hs_epochs}/{args.opt_epochs}/{args.qat_epochs}", "",
             "| stage | mAP | mAP50 | mAP75 | mAP50-95 | recall |", "|---|---|---|---|---|---|"]
    for name, r in rows.items():
        lines.append(f"| {name} | {r['mAP']:.4f} | {r['mAP50']:.4f} | {r['mAP75']:.4f} | "
                     f"{r['mAP50_95']:.4f} | {r['recall']:.4f} |")
    results = osp.join(out, "RESULTS.md")
    with open(results, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwritten: {results}")


def stage_configs(out: str, model: str, hs_ckpt: str, calib_amax: str):
    """(hyper-search, RepOpt, QAT) stage config paths under <out>/configs:
    the RepOpt and QAT stages read their scales from the hyper-search
    checkpoint, the QAT stage its amax from the calibration stage."""
    hs_cfg = write_stage_cfg(out, "hs", f"{model}_hs.py")
    opt_cfg = write_stage_cfg(out, "opt", f"{model}_opt.py", f"scales = {hs_ckpt!r}\n")
    qat_cfg = write_stage_cfg(
        out, "qat", f"{model}_opt_qat.py",
        f"scales = {hs_ckpt!r}\n"
        f"qat = dict(calib_pt={calib_amax!r}, sensitive_layers_skip=False,\n"
        f"           sensitive_layers_list=[])\n")
    return hs_cfg, opt_cfg, qat_cfg


if __name__ == "__main__":
    main()
