"""PR-metric toolkit: AP per class, PR/F1 curves, confusion matrix, and the
LP per-slot character confusions (copied from yololp_tpu/utils/metrics.py).

numpy on the host; plotting imports matplotlib inside the plot functions
and does nothing where it is not installed.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

# numpy 2 renamed trapz (the same rule); numpy 1 has only the old name
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def compute_ap(recall, precision):
    """101-point interpolated AP; returns (ap, mpre, mrec)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, plot=False, save_dir=".",
                 names: Sequence[str] = ()):
    """AP/P/R/F1 per class from per-detection TP flags.

    tp: (N, n_iou) bool/int, conf: (N,), pred_cls: (N,), target_cls: (M,).
    Returns (p, r, ap, f1, unique_classes).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    py = []
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = (target_cls == c).sum()
        if i.sum() == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if plot and j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p * r / (p + r + 1e-16)
    if plot and py:
        _plot_pr_curve(px, py, ap, os.path.join(save_dir, "PR_curve.png"), names)
        _plot_mc_curve(px, f1, os.path.join(save_dir, "F1_curve.png"), names, "F1")
        _plot_mc_curve(px, p, os.path.join(save_dir, "P_curve.png"), names,
                       "Precision")
        _plot_mc_curve(px, r, os.path.join(save_dir, "R_curve.png"), names,
                       "Recall")
    return p, r, ap, f1, unique_classes.astype(np.int32)


class ConfusionMatrix:
    """Per-class confusion matrix with a background row and column."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections, labels):
        """detections (N, 6) [x1 y1 x2 y2 conf cls]; labels (M, 5)
        [cls x1 y1 x2 y2]."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        dt_classes = detections[:, 5].astype(int)
        if len(labels) and len(detections):
            a, b = labels[:, 1:5], detections[:, :4]
            area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
            area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            lt = np.maximum(a[:, None, :2], b[None, :, :2])
            rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[..., 0] * wh[..., 1]
            iou = inter / (area_a[:, None] + area_b[None, :] - inter + 1e-12)
            x = np.argwhere(iou > self.iou_thres)
            if x.shape[0]:
                ious = iou[x[:, 0], x[:, 1]]
                order = np.argsort(-ious)
                x = x[order]
                x = x[np.unique(x[:, 1], return_index=True)[1]]
                x = x[np.argsort(-iou[x[:, 0], x[:, 1]])]
                x = x[np.unique(x[:, 0], return_index=True)[1]]
            matched_gt = set(x[:, 0]) if x.shape[0] else set()
            matched_dt = set(x[:, 1]) if x.shape[0] else set()
            for gi, di in x:
                self.matrix[dt_classes[di], gt_classes[gi]] += 1
            for gi in range(len(labels)):
                if gi not in matched_gt:
                    self.matrix[self.nc, gt_classes[gi]] += 1  # FN
            for di in range(len(detections)):
                if di not in matched_dt:
                    self.matrix[dt_classes[di], self.nc] += 1  # FP
        elif len(labels):
            for gi in range(len(labels)):
                self.matrix[self.nc, gt_classes[gi]] += 1
        elif len(detections):
            for di in range(len(detections)):
                self.matrix[dt_classes[di], self.nc] += 1

    def plot(self, save_dir=".", names: Sequence[str] = ()):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        m = self.matrix / (self.matrix.sum(0, keepdims=True) + 1e-6)
        fig, ax = plt.subplots(figsize=(10, 8), tight_layout=True)
        im = ax.imshow(m, cmap="Blues")
        fig.colorbar(im)
        labels = list(names) + ["background"]
        if len(labels) == m.shape[0]:
            ax.set_xticks(range(len(labels)))
            ax.set_yticks(range(len(labels)))
            ax.set_xticklabels(labels, rotation=90, fontsize=7)
            ax.set_yticklabels(labels, fontsize=7)
        ax.set_xlabel("True")
        ax.set_ylabel("Predicted")
        fig.savefig(os.path.join(save_dir, "confusion_matrix.png"), dpi=160)
        plt.close(fig)


def character_confusions(preds, targets, nads: int = 37):
    """LP-specific: per-slot character confusion counts over matched pairs.

    preds/targets as produced by Evaler.predict (28-col dets, 20-col gts).
    Returns (8, ncls+1, ncls+1) matrices for [pro, alp, ad0..ad5]."""
    sizes = [31, 24] + [nads] * 6
    mats = [np.zeros((s + 1, s + 1), int) for s in sizes]
    for pred, target in zip(preds, targets):
        if len(pred) == 0 or len(target) == 0:
            continue
        a, b = pred[:, :4], target[:, 8:12]
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        iou = wh[..., 0] * wh[..., 1] / (
            area_a[:, None] + area_b[None, :] - wh[..., 0] * wh[..., 1] + 1e-12)
        best = iou.argmax(0)
        for k in range(len(target)):
            if iou[best[k], k] < 0.5:
                continue
            for slot in range(8):
                t = int(target[k, slot])
                pcls = int(pred[best[k], 20 + slot])
                mats[slot][min(pcls, sizes[slot]), min(t, sizes[slot])] += 1
    return mats


def _plot_pr_curve(px, py, ap, save_path, names):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1)
    if 0 < len(names) < 21:
        for i, y in enumerate(py.T):
            ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
        ax.legend(fontsize=7)
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    fig.savefig(save_path, dpi=160)
    plt.close(fig)


def _plot_mc_curve(px, py, save_path, names, ylabel):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=str(names[i]))
        ax.legend(fontsize=7)
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    ax.plot(px, py.mean(0), linewidth=3, color="blue")
    ax.set_xlabel("Confidence")
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    fig.savefig(save_path, dpi=160)
    plt.close(fig)
