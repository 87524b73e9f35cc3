"""Convert Pascal VOC (VOCdevkit) annotations to YOLO txt labels and
assemble the standard VOC07+12 train/test split (mirrors tools/voc2yolo.py
of the JAX package). Host only.

The reference converter's class list, difficult-object filter and cx/cy/w/h
normalization (with the VOC 1-pixel origin offset), and the voc_07_12 layout
(train = train/val 2007+2012, val = test2007). Each (year, set) lands in
`images/{set}{year}`, where the assembly step reads it.

Usage:
    python -m yololp_tpu_torch.tools.voc2yolo --voc-path VOCdevkit [--link]

--link hardlinks instead of copying in the assembly stage (VOC07+12 is
~2.4 GB; hardlinks make the assembled view free).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import xml.etree.ElementTree as ET

VOC_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
_CLS_ID = {n: i for i, n in enumerate(VOC_NAMES)}

# (year, image_set) pairs that make up the VOC07+12 recipe
SPLITS = [("2012", "train"), ("2012", "val"),
          ("2007", "train"), ("2007", "val"), ("2007", "test")]
# assembled dataset: train = everything but test2007, val = test2007
ASSEMBLY = {"train": ["train2007", "val2007", "train2012", "val2012"],
            "val": ["test2007"]}


def parse_voc_xml(xml_path: str):
    """One annotation file -> (img_w, img_h, [(cls_id, xmin, xmax, ymin,
    ymax)]) with difficult objects and unknown classes dropped."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w, h = int(size.find("width").text), int(size.find("height").text)
    boxes = []
    for obj in root.iter("object"):
        name = obj.find("name").text
        difficult = obj.find("difficult")
        if name not in _CLS_ID or (difficult is not None
                                   and int(difficult.text) == 1):
            continue
        bb = obj.find("bndbox")
        boxes.append((_CLS_ID[name],
                      float(bb.find("xmin").text), float(bb.find("xmax").text),
                      float(bb.find("ymin").text), float(bb.find("ymax").text)))
    return w, h, boxes


def yolo_lines(w: int, h: int, boxes) -> str:
    """VOC corner boxes -> YOLO 'cls cx cy bw bh' normalized lines.
    Keeps the reference's VOC-origin convention: centers shift by the
    1-pixel VOC origin, widths/heights do not."""
    out = []
    for cls_id, xmin, xmax, ymin, ymax in boxes:
        cx = ((xmin + xmax) / 2.0 - 1) / w
        cy = ((ymin + ymax) / 2.0 - 1) / h
        bw = (xmax - xmin) / w
        bh = (ymax - ymin) / h
        out.append(f"{cls_id} {cx} {cy} {bw} {bh}")
    return "\n".join(out) + ("\n" if out else "")


def convert_split(voc_path: str, year: str, image_set: str) -> int:
    """Convert one VOC{year}/{image_set} into images/{set}{year} +
    labels/{set}{year}; returns the number of images converted."""
    ids_file = osp.join(voc_path, f"VOC{year}", "ImageSets", "Main",
                        f"{image_set}.txt")
    if not osp.isfile(ids_file):
        print(f"[warn] {ids_file} missing — skipping {image_set}{year}")
        return 0
    with open(ids_file) as f:
        image_ids = f.read().split()

    tag = f"{image_set}{year}"
    img_dir = osp.join(voc_path, "images", tag)
    lbl_dir = osp.join(voc_path, "labels", tag)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)

    n = 0
    for image_id in image_ids:
        src_img = osp.join(voc_path, f"VOC{year}", "JPEGImages",
                           f"{image_id}.jpg")
        xml = osp.join(voc_path, f"VOC{year}", "Annotations",
                       f"{image_id}.xml")
        if not osp.isfile(src_img) or not osp.isfile(xml):
            continue
        w, h, boxes = parse_voc_xml(xml)
        with open(osp.join(lbl_dir, f"{image_id}.txt"), "w") as f:
            f.write(yolo_lines(w, h, boxes))
        dst = osp.join(img_dir, f"{image_id}.jpg")
        if not osp.exists(dst):
            shutil.move(src_img, dst)
        n += 1
    print(f"[info] {tag}: {n} images")
    return n


def assemble_voc0712(voc_path: str, link: bool = False) -> str:
    """Build voc_07_12/{images,labels}/{train,val} from the per-split dirs."""
    root = osp.join(voc_path, "voc_07_12")
    place = os.link if link else shutil.copy2
    for kind in ("images", "labels"):
        for split, tags in ASSEMBLY.items():
            dst_dir = osp.join(root, kind, split)
            os.makedirs(dst_dir, exist_ok=True)
            for tag in tags:
                src_dir = osp.join(voc_path, kind, tag)
                if not osp.isdir(src_dir):
                    print(f"[warn] {src_dir} missing — skipping")
                    continue
                for name in os.listdir(src_dir):
                    dst = osp.join(dst_dir, name)
                    if not osp.exists(dst):
                        place(osp.join(src_dir, name), dst)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--voc-path", "--voc_path", default="VOCdevkit",
                    help="VOCdevkit root containing VOC2007/VOC2012")
    ap.add_argument("--link", action="store_true",
                    help="hardlink instead of copy when assembling voc_07_12")
    args = ap.parse_args(argv)

    for year, image_set in SPLITS:
        convert_split(args.voc_path, year, image_set)
    root = assemble_voc0712(args.voc_path, link=args.link)
    print(f"[info] assembled {root} (train=07+12 trainval, val=test2007)")


if __name__ == "__main__":
    main()
