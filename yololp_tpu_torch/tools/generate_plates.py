"""Standalone synthetic plate writer (mirrors tools/generate_plates.py of the
JAX package): N plate crops and their 20-float label rows, one style or the
mix. Host only.

Usage: python -m yololp_tpu_torch.tools.generate_plates --out plates/ --n 100 [--style blue]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


def get_args_parser():
    p = argparse.ArgumentParser("synthetic plate generator")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--style", choices=["blue", "green_s", "green_b", "yellow"], default=None,
                   help="fixed style; default samples the mix")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cjk-font", type=str, default=None)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    import cv2
    import numpy as np

    from yololp_tpu_torch.data.generate import PlateGenerator
    from yololp_tpu_torch.data.vocab import plate_string

    os.makedirs(osp.join(args.out, "images"), exist_ok=True)
    os.makedirs(osp.join(args.out, "labels"), exist_ok=True)
    gen = PlateGenerator(seed=args.seed, cjk_font_path=args.cjk_font)
    for i in range(args.n):
        plate, label, _mask = gen.generate(args.style)
        name = f"plate_{i:06d}"
        cv2.imwrite(osp.join(args.out, "images", name + ".jpg"), plate)
        h, w = plate.shape[:2]
        row = label[0].copy()
        x1, y1, x2, y2 = row[8:12]
        norm = np.concatenate([
            row[:8],
            [(x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h],
            row[12:20] / np.array([w, h] * 4)])
        with open(osp.join(args.out, "labels", name + ".txt"), "w") as f:
            f.write(" ".join(f"{v:.6f}" for v in norm))
    sample = gen.generate(args.style)[1][0]
    print(f"{args.n} plates written to {args.out} "
          f"(e.g. {plate_string(sample[0], sample[1], sample[2:8])})")


if __name__ == "__main__":
    main()
