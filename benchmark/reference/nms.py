"""Plain reference of the LP NMS over a (B, A, 290) decode: the mean-of-8
confidence gate, a stable descending top-K, exact sequential greedy NMS and
the kept rows in score order, at most `max_det` of them. The score is the 8
confidences summed left to right, over 8; IoU is overlap / (area1 + area2 -
overlap + 1e-9), widths, heights and areas clipped at 0.

A row of the result has 28 columns: [0:4] xyxy, [4:12] the corner quad,
[12:20] the 8 task confidences (province, alphabet, 6 characters) and
[20:28] their class ids (the first maximum). Each image's result also gives
the kept anchors' indices.
"""

from __future__ import annotations

import torch


def task_slices(npro=31, nalp=24, nads=37):
    out = [(0, npro), (npro, npro + nalp)]
    base = npro + nalp
    out += [(base + i * nads, base + (i + 1) * nads) for i in range(6)]
    return out


def rows_of(decode, vocab):
    """(..., A, 290) decode -> (..., A, 28) rows and (..., A) NMS scores."""
    cx, cy, w, h = decode[..., 0], decode[..., 1], decode[..., 2], decode[..., 3]
    box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    cls = decode[..., 13:] * decode[..., 4:5]
    confs, ids = [], []
    for lo, hi in task_slices(vocab["npro"], vocab["nalp"], vocab["nads"]):
        m, i = cls[..., lo:hi].max(-1)
        confs.append(m)
        ids.append(i)
    confs, ids = torch.stack(confs, -1), torch.stack(ids, -1)
    # first maximum, as the program's argmax: max() may return any of ties
    for t, (lo, hi) in enumerate(task_slices(vocab["npro"], vocab["nalp"], vocab["nads"])):
        hit = cls[..., lo:hi] == confs[..., t:t + 1]
        ids[..., t] = hit.float().argmax(-1)
    rows = torch.cat([box, decode[..., 5:13], confs, ids.to(decode.dtype)], -1)
    score = confs[..., 0]
    for t in range(1, 8):  # left to right, so that a score's last bit is the same on every device
        score = score + confs[..., t]
    return rows, score / 8.0


def iou_matrix(boxes):
    """(B, K, 4) xyxy -> (B, K, K) IoU, areas clipped at 0, eps 1e-9."""
    b1, b2 = boxes[:, :, None, :], boxes[:, None, :, :]
    wh = (torch.minimum(b1[..., 2:], b2[..., 2:]) - torch.maximum(b1[..., :2], b2[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[..., 2:] - boxes[..., :2]).clamp(min=0).prod(-1)
    return inter / (area[:, :, None] + area[:, None, :] - inter + 1e-9)


@torch.no_grad()
def nms(decode, vocab, conf_thres, iou_thres, max_det, topk):
    """Per image a dict: `rows` (n, 28) and `idx` (n,) anchor indices of the
    kept detections; `keep`, the K-long keep mask over the sorted
    candidates, and `n_valid`, the candidates that passed the gate."""
    rows, score = rows_of(decode, vocab)
    gated = torch.where(score >= conf_thres, score, torch.zeros_like(score))
    k = min(topk, decode.shape[1])
    order = torch.sort(gated, dim=1, descending=True, stable=True).indices[:, :k]
    s = torch.gather(gated, 1, order)
    boxes = torch.gather(rows[..., :4], 1, order[..., None].expand(-1, -1, 4))
    sup = iou_matrix(boxes) > iou_thres
    keep = torch.zeros_like(s, dtype=torch.bool)
    valid = s > 0
    for i in range(k):
        hit = (sup[:, :i, i] & keep[:, :i]).any(-1)
        keep[:, i] = valid[:, i] & ~hit
    out = []
    for n in range(decode.shape[0]):
        idx = order[n][keep[n]][:max_det]
        out.append(dict(rows=rows[n, idx], idx=idx, keep=keep[n].tolist(),
                        n_valid=int(valid[n].sum())))
    return out
