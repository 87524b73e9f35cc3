"""Strict-metric failure decomposition: what gates the LP mAP (mirrors
tools/diag_strict.py of the JAX package).

The LP metric (core/evaler.py:Evaler.eval) needs, per ground-truth plate, a
matched box (IoU >= 0.7 to count in the headline mAP), the corner criterion
(mean L1 of the 8 corner coordinates < 0.1 * sqrt(area)) and all eight
characters right. This tool splits the misses into those stages and reports
the per-slot accuracy and the top confusion pairs. `decompose` and `report`
work on in-memory (preds, targets) as `Evaler.predict` returns them.

Usage:
  python -m yololp_tpu_torch.tools.diag_strict --ckpt best_ckpt.msgpack \\
      --data data.yaml --conf-file yololps --img-size 448 [--device cpu]

The model computes in bf16 on the card (the JAX tool's dtype) and in fp32 on
the CPU (`--device cpu`).
"""

from __future__ import annotations

import argparse

import numpy as np

from yololp_tpu_torch.data.vocab import ADS_NAMES, ALP_NAMES, PRO_NAMES

SLOT_NAMES = ["pro", "alp", "ad0", "ad1", "ad2", "ad3", "ad4", "ad5"]
SLOT_VOCABS = [PRO_NAMES, ALP_NAMES] + [ADS_NAMES] * 6


def decompose(preds, targets):
    """Per-GT stage pass counts at the headline (IoU >= 0.7) gate: (stats,
    slot_total, slot_right, n_wrong_slots) with stats the counts gt,
    matched50, matched70, corner_ok, cls_ok and both_ok, the per-slot totals
    and rights over matched70, and the histogram of wrong slots a plate."""
    from yololp_tpu_torch.core.evaler import Evaler

    n_gt = sum(len(t) for t in targets)
    stats = dict(gt=n_gt, matched50=0, matched70=0, corner_ok=0, cls_ok=0, both_ok=0)
    slot_total = np.zeros(8, int)
    slot_right = np.zeros(8, int)
    n_wrong_slots = np.zeros(9, int)  # histogram: how many slots wrong
    for pred, target in zip(preds, targets):
        if len(target) == 0 or len(pred) == 0:
            continue
        iou = Evaler._box_iou(pred[:, :4], target[:, 8:12])
        best_iou = iou.max(0)
        best_pred = iou.argmax(0)
        for k in range(len(target)):
            if best_iou[k] < 0.5:
                continue
            stats["matched50"] += 1
            if best_iou[k] < 0.7:
                continue
            stats["matched70"] += 1
            p, t = pred[best_pred[k]], target[k]
            tb = t[8:12]
            area = (tb[2] - tb[0]) * (tb[3] - tb[1])
            is_cor = np.abs(p[4:12] - t[12:20]).sum() / 8.0 < 0.1 * np.sqrt(max(area, 0.0))
            slots_ok = p[20:28].astype(int) == t[:8].astype(int)
            slot_total += 1
            slot_right += slots_ok
            n_wrong_slots[8 - slots_ok.sum()] += 1
            stats["corner_ok"] += int(is_cor)
            stats["cls_ok"] += int(slots_ok.all())
            stats["both_ok"] += int(is_cor and slots_ok.all())
    return stats, slot_total, slot_right, n_wrong_slots


def top_confusions(mats, k=5):
    """[(slot name, ["true->pred xN", ...])], the k largest off-diagonal
    in-vocabulary counts of each slot's (pred, true) matrix."""
    out = []
    for slot, (m, vocab) in enumerate(zip(mats, SLOT_VOCABS)):
        m = m.copy()
        np.fill_diagonal(m, 0)
        pairs = []
        core = m[: len(vocab), : len(vocab)]
        flat = np.argsort(core.ravel())[::-1][:k]
        for idx in flat:
            pcls, tcls = np.unravel_index(idx, core.shape)
            if core[pcls, tcls] == 0:
                break
            pairs.append(f"{vocab[tcls]}->{vocab[pcls]} x{core[pcls, tcls]}")
        out.append((SLOT_NAMES[slot], pairs))
    return out


def report(results, preds, targets, nads: int = 37):
    """Print the JAX tool's report for the metric list `results`
    (Evaler.eval's) and the per-image (preds, targets); returns
    (decompose's four values, character_confusions' matrices)."""
    from yololp_tpu_torch.utils.metrics import character_confusions

    mAP, mAP50, mAP75, mAP5095, recall = results[:5]
    print(f"\nstrict metric: mAP={mAP:.4f} mAP50={mAP50:.4f} recall={recall:.4f}")

    stats, slot_total, slot_right, n_wrong = decompose(preds, targets)
    g = stats["gt"]
    m70 = max(stats["matched70"], 1)
    print(f"\nstage funnel over {g} GT plates (headline gate IoU>=0.7):")
    print(f"  matched @IoU>=0.5      {stats['matched50']:6d}  "
          f"({stats['matched50'] / max(g, 1):.3f} of GT)")
    print(f"  matched @IoU>=0.7      {stats['matched70']:6d}  "
          f"({stats['matched70'] / max(g, 1):.3f} of GT)")
    print(f"  corner criterion pass  {stats['corner_ok']:6d}  "
          f"({stats['corner_ok'] / m70:.3f} of matched70)")
    print(f"  all-8-chars pass       {stats['cls_ok']:6d}  "
          f"({stats['cls_ok'] / m70:.3f} of matched70)")
    print(f"  both (scored right)    {stats['both_ok']:6d}  "
          f"({stats['both_ok'] / m70:.3f} of matched70)")

    print("\nper-slot accuracy on matched70:")
    for name, r, t in zip(SLOT_NAMES, slot_right, slot_total):
        print(f"  {name}: {r / max(t, 1):.4f}  ({t - r} wrong)")
    print("\n#wrong-slots histogram (matched70): "
          + " ".join(f"{i}:{c}" for i, c in enumerate(n_wrong) if c))

    mats = character_confusions(preds, targets, nads=nads)
    print("\ntop confusion pairs per slot (true->pred):")
    for name, pairs in top_confusions(mats):
        if pairs:
            print(f"  {name}: " + ", ".join(pairs))
    return (stats, slot_total, slot_right, n_wrong), mats


def get_args_parser():
    p = argparse.ArgumentParser("strict-metric failure decomposition (PyTorch/CUDA)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--conf-file", default="yololps")
    p.add_argument("--img-size", type=int, default=448)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--conf-thres", type=float, default=0.03)
    p.add_argument("--iou-thres", type=float, default=0.65)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--workers", type=int, default=2)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    from yololp_tpu_torch.core.evaler import run_eval
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.data.vocab import load_dataset_yaml
    from yololp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    data_dict = load_dataset_yaml(args.data)
    nads = int(data_dict.get("nads", 37))
    inferer = Inferer(None, args.ckpt, args.conf_file, img_size=args.img_size,
                      half=dev.type == "cuda", npro=int(data_dict.get("npro", 31)),
                      nalp=int(data_dict.get("nalp", 24)), nads=nads, device=dev)
    results, _speed, (preds, targets, _paths) = run_eval(
        inferer.model, None, data_dict, batch_size=args.batch_size, img_size=args.img_size,
        conf_thres=args.conf_thres, iou_thres=args.iou_thres, workers=args.workers,
        return_preds=True, device=dev)
    return report(results, preds, targets, nads=nads)


if __name__ == "__main__":
    main()
