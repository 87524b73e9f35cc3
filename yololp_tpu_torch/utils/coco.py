"""COCO-format export for the generic (non-LP) evaluation path (a copy of
yololp_tpu/utils/coco.py).

Behavioral reference: datasets.py generate_coco_format_labels (val-split
annotation json) and evaler.py predict_model/eval_model (prediction json +
pycocotools COCOeval). pycocotools is optional: the jsons are emitted in
standard COCO format, and COCOeval runs when the package is importable.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence


def generate_coco_annotations(img_paths: Sequence[str],
                              labels: Sequence, shapes: Sequence,
                              class_names: Sequence[str], save_path: str):
    """Write instances_val.json from dataset labels (datasets.py:682-735).

    labels rows: normalized [cls..., cx, cy, w, h, ...] — only the box and
    the first class slot are used for the COCO dump (matching the reference,
    which exports class-0-style detection annotations)."""
    dataset = {"categories": [], "annotations": [], "images": []}
    for i, name in enumerate(class_names):
        dataset["categories"].append(
            {"id": i, "name": str(name), "supercategory": ""})
    ann_id = 0
    for img_path, lbl, (img_h, img_w) in zip(img_paths, labels, shapes):
        img_id = os.path.splitext(os.path.basename(img_path))[0]
        dataset["images"].append({"file_name": os.path.basename(img_path),
                                  "id": img_id, "width": img_w,
                                  "height": img_h})
        for row in lbl:
            c = int(row[0])
            cx, cy, w, h = row[8:12]
            x1 = (cx - w / 2) * img_w
            y1 = (cy - h / 2) * img_h
            bw, bh = max(0.0, float(w * img_w)), max(0.0, float(h * img_h))
            dataset["annotations"].append({
                "area": bh * bw, "bbox": [float(x1), float(y1), bw, bh],
                "category_id": c, "id": ann_id, "image_id": img_id,
                "iscrowd": 0, "segmentation": []})
            ann_id += 1
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    with open(save_path, "w") as f:
        json.dump(dataset, f)
    return save_path


def predictions_to_coco_json(per_image_dets: Dict[str, "np.ndarray"],
                             save_path: str):
    """28-col detections -> COCO results json (evaler.py predict_model
    convention: xywh boxes, mean-of-8 score, province id as category)."""
    results: List[Dict] = []
    for img_path, dets in per_image_dets.items():
        img_id = os.path.splitext(os.path.basename(img_path))[0]
        for d in dets:
            x1, y1, x2, y2 = (float(v) for v in d[:4])
            score = float(d[12:20].mean())
            results.append({
                "image_id": img_id,
                "category_id": int(d[20]),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": score,
            })
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    with open(save_path, "w") as f:
        json.dump(results, f)
    return save_path


def cocoeval_if_available(anno_json: str, pred_json: str):
    """Run pycocotools COCOeval when installed (evaler.py:417-505)."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        return None
    anno = COCO(anno_json)
    pred = anno.loadRes(pred_json)
    ev = COCOeval(anno, pred, "bbox")
    ev.params.imgIds = [img["id"] for img in anno.dataset["images"]]
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev.stats
