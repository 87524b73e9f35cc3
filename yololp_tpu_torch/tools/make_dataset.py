"""Generate a synthetic CCPD-like dataset and its yaml, in resumable chunks
(mirrors tools/make_dataset.py of the JAX package).

Wraps data/synthetic.make_synthetic_dataset, chunked by its `start` offset
so that an interrupted generation continues where it stopped, and writes
the data yaml the train and eval CLIs read (<root>.yaml). Host only.

Usage:
  python -m yololp_tpu_torch.tools.make_dataset --root runs/data/synth14k \\
      --n-train 14000 --n-val 2000 --img-size 640 --ratio-min 0.16 --ratio-max 0.5 \\
      --diversity 1.0
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time


def get_args_parser():
    p = argparse.ArgumentParser("synthetic dataset generator")
    p.add_argument("--root", required=True)
    p.add_argument("--n-train", type=int, default=14000)
    p.add_argument("--n-val", type=int, default=2000)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ratio-min", type=float, default=0.1)
    p.add_argument("--ratio-max", type=float, default=0.4)
    p.add_argument("--diversity", type=float, default=0.0)
    p.add_argument("--chunk", type=int, default=1000)
    p.add_argument("--cjk-font", type=str, default=None)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    from yololp_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.time()
    kw = dict(img_size=args.img_size, seed=args.seed, cjk_font_path=args.cjk_font,
              ratio_min=args.ratio_min, ratio_max=args.ratio_max, diversity=args.diversity)

    def resume_point(split):
        """Images already written, rounded down to a chunk boundary."""
        d = osp.join(args.root, "images", split)
        if not osp.isdir(d):
            return 0
        n = sum(1 for f in os.listdir(d) if f.endswith(".jpg"))
        return (n // args.chunk) * args.chunk

    # each split resumes on its own, in the same chunked rng-stream scheme
    for split, total in (("train", args.n_train), ("val", args.n_val)):
        done = resume_point(split)
        if done:
            print(f"resuming at {split} image {done}")
        for start in range(done, total, args.chunk):
            n = min(args.chunk, total - start)
            make_synthetic_dataset(args.root, n_train=n if split == "train" else 0,
                                   n_val=n if split == "val" else 0, start=start, **kw)
            print(f"{split} {start + n}/{total}  ({time.time() - t0:.0f}s elapsed)", flush=True)

    # a zero-image call returns the data dict (paths and vocab sizes), so an
    # already complete generation still writes the yaml
    data = make_synthetic_dataset(args.root, n_train=0, n_val=0, **kw)
    yaml_path = args.root.rstrip("/") + ".yaml"
    with open(yaml_path, "w") as f:
        for k, v in data.items():
            f.write(f"{k}: {v}\n")
    print(f"wrote {yaml_path}")
    return data


if __name__ == "__main__":
    main()
