"""Province-head diagnostic: accuracy against plate size, and confusion pairs
(mirrors tools/diag_province.py of the JAX package).

Matches detections to ground truth at IoU >= 0.5 (each detection used once)
and buckets the province accuracy by the gt plate's pixel width at eval
resolution, which separates two failure modes behind a high pro_loss:
illegibility (accuracy collapses below a width) and glyph confusion (flat in
size, a few (true, pred) pairs dominate). `analyse` works on in-memory
(preds, targets) as `Evaler.predict` returns them; `report` prints it.

Usage:
  python -m yololp_tpu_torch.tools.diag_province --ckpt final_ckpt.msgpack \\
      --data data.yaml --img-size 320 [--device cpu]

The model computes in bf16 on the card (the JAX tool's dtype) and in fp32 on
the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse
import collections
import json

import numpy as np

WIDTH_EDGES = [0, 40, 60, 80, 100, 130, 1e9]


def analyse(preds, targets):
    """{"gt", "matched", "buckets": [(lo, hi, n, det %, pro acc %)] for the
    non-empty width buckets, "confusions": Counter of (true, pred) province
    ids over matched wrong plates, "per_province": {true id: (right, matched)}}."""
    from yololp_tpu_torch.core.evaler import Evaler

    rows = []  # (gt plate width px, true pro, pred pro or -1)
    n_gt = n_matched = 0
    for det, tgt in zip(preds, targets):
        n_gt += len(tgt)
        if len(tgt) == 0:
            continue
        if len(det) == 0:
            rows += [(float(t[10] - t[8]), int(t[0]), -1) for t in tgt]
            continue
        iou = Evaler._box_iou(det[:, :4], tgt[:, 8:12])
        used = set()
        for ti in range(len(tgt)):
            cand = [(iou[pi, ti], pi) for pi in range(len(det))
                    if pi not in used and iou[pi, ti] >= 0.5]
            if cand:
                _, pi = max(cand)
                used.add(pi)
                n_matched += 1
                rows.append((float(tgt[ti, 10] - tgt[ti, 8]), int(tgt[ti, 0]), int(det[pi, 20])))
            else:
                rows.append((float(tgt[ti, 10] - tgt[ti, 8]), int(tgt[ti, 0]), -1))

    widths = np.array([r[0] for r in rows])
    ok = np.array([r[1] == r[2] for r in rows])
    det_ok = np.array([r[2] >= 0 for r in rows])
    buckets = []
    for lo, hi in zip(WIDTH_EDGES[:-1], WIDTH_EDGES[1:]):
        m = (widths >= lo) & (widths < hi)
        if m.sum() == 0:
            continue
        acc = 100 * ok[m & det_ok].mean() if (m & det_ok).any() else 0
        buckets.append((lo, hi, int(m.sum()), 100 * det_ok[m].mean(), acc))
    confusions = collections.Counter((r[1], r[2]) for r in rows if r[2] >= 0 and r[1] != r[2])
    per_true = collections.defaultdict(lambda: [0, 0])
    for r in rows:
        if r[2] >= 0:
            per_true[r[1]][1] += 1
            per_true[r[1]][0] += int(r[1] == r[2])
    return dict(gt=n_gt, matched=n_matched, buckets=buckets, confusions=confusions,
                per_province={k: tuple(v) for k, v in sorted(per_true.items())})


def report(res):
    """Print `analyse`'s result as the JAX tool prints it."""
    from yololp_tpu_torch.data.vocab import PRO_NAMES

    n_gt, n_matched = res["gt"], res["matched"]
    print(f"gt plates: {n_gt}  matched: {n_matched} "
          f"({100 * n_matched / max(n_gt, 1):.1f}%)")
    print(f"{'plate width px':>16} {'n':>6} {'det%':>6} {'pro acc%':>9}")
    for lo, hi, n, det_pct, acc in res["buckets"]:
        lab = f"[{lo:.0f},{'inf' if hi > 1e8 else f'{hi:.0f}'})"
        print(f"{lab:>16} {n:>6} {det_pct:>5.1f} {acc:>8.1f}")
    print("\ntop confusions (true -> pred, count):")
    for (t, pr), c in res["confusions"].most_common(15):
        print(f"  {PRO_NAMES[t]} -> {PRO_NAMES[pr]}: {c}")
    accs = {PRO_NAMES[k]: round(right / n, 3)
            for k, (right, n) in res["per_province"].items() if n >= 5}
    print("\nper-province acc:", json.dumps(accs, ensure_ascii=False))


def get_args_parser():
    p = argparse.ArgumentParser("province-head diagnostic (PyTorch/CUDA)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--conf-file", default="yololps")
    p.add_argument("--img-size", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--max-images", type=int, default=0, help="0 = all")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.data.vocab import load_dataset_yaml
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    data_dict = load_dataset_yaml(args.data)
    inferer = Inferer(None, args.ckpt, Config.named(args.conf_file), img_size=args.img_size,
                      half=dev.type == "cuda", npro=int(data_dict.get("npro", 31)),
                      nalp=int(data_dict.get("nalp", 24)), nads=int(data_dict.get("nads", 37)),
                      device=dev)
    ev = Evaler(data_dict, batch_size=args.batch_size, img_size=args.img_size,
                conf_thres=args.conf_thres, device=dev)
    loader, _ = ev.init_data("val")
    preds, targets = ev.predict(ev.make_infer_fn(inferer.model), loader)
    if args.max_images:
        preds, targets = preds[: args.max_images], targets[: args.max_images]
    res = analyse(preds, targets)
    report(res)
    return res


if __name__ == "__main__":
    main()
