"""Dataset visualization (mirrors tools/vis_dataset.py of the JAX package):
N samples, optionally through the train-time augmentation, drawn with their
labels, and a grid of them, for label sanity checks. Host only.

Usage:
  python -m yololp_tpu_torch.tools.vis_dataset --img-dir data/images/train --out vis/ \\
      --n 8 [--augment]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp


def get_args_parser():
    p = argparse.ArgumentParser("dataset visualization")
    p.add_argument("--img-dir", required=True)
    p.add_argument("--out", default="./vis")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--augment", action="store_true",
                   help="apply the full train augmentation pipeline")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    import random

    import cv2

    from yololp_tpu_torch.data.datasets import TrainValDataset
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.visualize import draw_labels, image_grid

    random.seed(args.seed)
    hyp = Config.named("yololps")["data_aug"] if args.augment else {}
    ds = TrainValDataset(args.img_dir, img_size=args.img_size, augment=args.augment,
                         hyp=dict(hyp), seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    drawn = []
    for i in range(min(args.n, len(ds))):
        rgb, labels, mask, path, _ = ds[i]
        img = draw_labels(cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), labels[mask > 0])
        cv2.imwrite(osp.join(args.out, f"sample_{i}_{osp.basename(path)}"), img)
        drawn.append(img)
    cv2.imwrite(osp.join(args.out, "grid.jpg"), image_grid(drawn))
    print(f"{len(drawn)} annotated samples + grid.jpg written to {args.out}")


if __name__ == "__main__":
    main()
