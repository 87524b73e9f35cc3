"""Dataset statistics (mirrors tools/count_ccpd.py of the JAX package):
per-class counts of the province, letter and character slots and the mean
box size, saved as stats.json and (with matplotlib) bar charts. Host only.

Usage: python -m yololp_tpu_torch.tools.count_ccpd --labels CCPD_yololp/labels/train --out stats/
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp

import numpy as np

from yololp_tpu_torch.data.vocab import ADS_NAMES, ALP_NAMES, PRO_NAMES


def get_args_parser():
    p = argparse.ArgumentParser("count CCPD labels")
    p.add_argument("--labels", required=True, help="labels/<split> dir")
    p.add_argument("--out", default="./stats")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    pro_cnt = np.zeros(len(PRO_NAMES), int)
    alp_cnt = np.zeros(len(ALP_NAMES), int)
    ads_cnt = np.zeros(len(ADS_NAMES), int)
    widths, heights, n_plates, n_empty = [], [], 0, 0

    for txt in glob.glob(osp.join(args.labels, "*.txt")):
        with open(txt) as f:
            rows = [r.split() for r in f.read().strip().splitlines() if r]
        if not rows:
            n_empty += 1
            continue
        for r in rows:
            vals = [float(v) for v in r]
            pro_cnt[int(vals[0])] += 1
            alp_cnt[int(vals[1])] += 1
            for a in vals[2:8]:
                ads_cnt[int(a)] += 1
            widths.append(vals[10])
            heights.append(vals[11])
            n_plates += 1

    stats = {
        "n_plates": n_plates,
        "n_empty_images": n_empty,
        "pro": {PRO_NAMES[i]: int(c) for i, c in enumerate(pro_cnt)},
        "alp": {ALP_NAMES[i]: int(c) for i, c in enumerate(alp_cnt)},
        "ads": {ADS_NAMES[i]: int(c) for i, c in enumerate(ads_cnt)},
        "box_w_mean": float(np.mean(widths)) if widths else 0.0,
        "box_h_mean": float(np.mean(heights)) if heights else 0.0,
    }
    with open(osp.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, ensure_ascii=False, indent=1)
    print(f"{n_plates} plates in {args.labels} ({n_empty} empty images)")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for name, cnt, labels in (("pro", pro_cnt, PRO_NAMES),
                                  ("alp", alp_cnt, ALP_NAMES),
                                  ("ads", ads_cnt, ADS_NAMES)):
            fig, ax = plt.subplots(figsize=(12, 4))
            ax.bar(range(len(cnt)), cnt)
            ax.set_xticks(range(len(cnt)))
            ax.set_xticklabels(labels, fontsize=7)
            ax.set_title(f"{name} class counts")
            fig.savefig(osp.join(args.out, f"{name}_counts.png"), dpi=120)
            plt.close(fig)
        print(f"plots written to {args.out}")
    except ImportError:
        pass
    return stats


if __name__ == "__main__":
    main()
