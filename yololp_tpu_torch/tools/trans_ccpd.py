"""CCPD2019/CCPD2020 -> YOLO-LP label converter (mirrors tools/trans_ccpd.py
of the JAX package). Host only.

CCPD encodes the annotation in the filename:
  <area>-<tilt>-<x1&y1_x2&y2>-<br&_bl&_tl&_tr corners>-<p_a_c...>-<bright>-<blur>.jpg
on 720x1160 images. Output layout: <out>/images/<split>/*.jpg +
<out>/labels/<split>/*.txt with 20-float rows
[pro, alp, ads0..5, cx, cy, w, h, x1..y4] normalized.

Usage:
  python -m yololp_tpu_torch.tools.trans_ccpd --ccpd2019 CCPD2019 --ccpd2020 CCPD2020 \
      --output CCPD_yololp [--link]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from shutil import copy

IMG_W, IMG_H = 720.0, 1160.0


def parse_ccpd_name(img_name: str, is_2020: bool):
    """Filename -> 20-float label row (or None if classes out of range)."""
    parts = osp.splitext(img_name)[0].split("-")
    if len(parts) < 5:
        return None
    tl, br = (p.split("&") for p in parts[2].split("_"))
    x1, y1, x2, y2 = float(tl[0]), float(tl[1]), float(br[0]), float(br[1])
    w, h = x2 - x1, y2 - y1
    box = [(x1 + w / 2) / IMG_W, (y1 + h / 2) / IMG_H, w / IMG_W, h / IMG_H]

    # corner order in the filename: BR, BL, TL, TR; label order: TL BL BR TR
    cbr, cbl, ctl, ctr = (p.split("&") for p in parts[3].split("_"))
    corners = [int(ctl[0]) / IMG_W, int(ctl[1]) / IMG_H,
               int(cbl[0]) / IMG_W, int(cbl[1]) / IMG_H,
               int(cbr[0]) / IMG_W, int(cbr[1]) / IMG_H,
               int(ctr[0]) / IMG_W, int(ctr[1]) / IMG_H]

    no = [int(x) for x in parts[4].split("_")]
    if not is_2020:
        no = no[:7] + [36]  # 7-char plates pad slot 8 with 'O'
    if len(no) != 8:
        return None
    # class-range validation: province < 31, letter < 24, characters < 34
    if no[0] >= 31 or no[1] >= 24:
        return None
    hi = 7 if not is_2020 else 8
    for i in range(2, hi):
        if no[i] >= 34:
            return None
    if not is_2020 and no[7] > 36:
        return None
    return no + box + corners


def write_sample(img_path, label, out_img, out_lbl, link: bool):
    if link:
        if not osp.exists(out_img):
            os.symlink(osp.abspath(img_path), out_img)
    else:
        copy(img_path, out_img)
    with open(out_lbl, "w") as f:
        if label is not None:
            f.write(" ".join(str(v) for v in label))


def out_dirs(output, split):
    img_dir = osp.join(output, "images", split)
    lbl_dir = osp.join(output, "labels", split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    return img_dir, lbl_dir


def trans_2019(root, output, indices, link):
    """CCPD2019: splits/{train,val,test}.txt list relative image paths."""
    for split in ("train", "val", "test"):
        txt = osp.join(root, "splits", f"{split}.txt")
        if not osp.isfile(txt):
            print(f"skip 2019 {split}: no {txt}")
            continue
        img_dir, lbl_dir = out_dirs(output, split)
        idx = indices[split]
        n_bad = 0
        with open(txt) as f:
            for line in f:
                rel = line.strip()
                if not rel:
                    continue
                img_path = osp.join(root, rel)
                label = parse_ccpd_name(osp.basename(rel), is_2020=False)
                n_bad += label is None
                write_sample(img_path, label,
                             osp.join(img_dir, f"{split}{idx}.jpg"),
                             osp.join(lbl_dir, f"{split}{idx}.txt"), link)
                idx += 1
        indices[split] = idx
        print(f"2019 {split}: {idx} total, {n_bad} invalid labels")
    return indices


def trans_2020(root, output, indices, link):
    """CCPD2020: ccpd_green/{train,val,test} hold the images directly."""
    for split in ("train", "val", "test"):
        src = osp.join(root, "ccpd_green", split)
        if not osp.isdir(src):
            print(f"skip 2020 {split}: no {src}")
            continue
        img_dir, lbl_dir = out_dirs(output, split)
        idx = indices[split]
        n_bad = 0
        for name in sorted(os.listdir(src)):
            label = parse_ccpd_name(name, is_2020=True)
            n_bad += label is None
            write_sample(osp.join(src, name), label,
                         osp.join(img_dir, f"{split}{idx}.jpg"),
                         osp.join(lbl_dir, f"{split}{idx}.txt"), link)
            idx += 1
        indices[split] = idx
        print(f"2020 {split}: {idx} total, {n_bad} invalid labels")
    return indices


def get_args_parser():
    p = argparse.ArgumentParser("CCPD -> YOLO-LP converter")
    p.add_argument("--ccpd2019", type=str, default=None)
    p.add_argument("--ccpd2020", type=str, default=None)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--link", action="store_true", help="symlink images instead of copying")
    return p


def main(argv=None):
    parser = get_args_parser()
    args = parser.parse_args(argv)
    if not (args.ccpd2019 or args.ccpd2020):
        parser.error("provide at least one CCPD root")
    os.makedirs(args.output, exist_ok=True)
    indices = {"train": 0, "val": 0, "test": 0}
    if args.ccpd2019:
        indices = trans_2019(args.ccpd2019, args.output, indices, args.link)
    if args.ccpd2020:
        indices = trans_2020(args.ccpd2020, args.output, indices, args.link)
    print("done:", indices)
    return indices


if __name__ == "__main__":
    main()
