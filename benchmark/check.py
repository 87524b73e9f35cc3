"""The comparison that decides `correct` for a served detector.

A served batch is (det, valid, num): per image `num` detections, rows of 28
(box xyxy, corner quad, 8 task confidences, 8 class ids), flagged by
`valid` at the front of `det`. Two stages are judged, each against the
plain reference (reference/):

- The NMS stage, exactly: the reference NMS (gate, stable top-K, greedy
  suppression, max_det) of the program's own decode of the same batch.
  `nms_images_differ` counts the images whose served detections are not the
  reference's: another `num`, `valid` not the first `num` slots, or any
  kept row not equal bit for bit (rows of equal score may come in either
  order). Taking the program's decode leaves out the bf16 rounding, which
  moves candidates across the gate, the top-K and the IoU threshold.
- The forward and decode, within limits: the reference's fp32 decode of
  every anchor. Each served row is paired with the reference anchor whose
  box and corners lie nearest (largest coordinate gap, in pixels), and its
  coordinate and confidence gaps to it are taken. The same is done for the
  kept rows of the reference computed with bf16-rounded conv inputs and
  weights; the number compared is the ratio of the mean coordinate gaps,
  `box_err_ratio` (`compare`). An image served with no rows where the
  reference kept some reads infinite.

`correct` holds when every number named in the cell's limits file is at or
under its limit.
"""

from __future__ import annotations

import numpy as np
import torch


def served_rows(out):
    """Per image the (num, 28) rows of a served (det, valid, num)."""
    det, valid, num = out
    return [det[j][valid[j]][: int(num[j])] for j in range(det.shape[0])]


def _canonical(rows: np.ndarray) -> np.ndarray:
    """Rows ordered by score (the left-to-right mean of the 8 confidences,
    in float32), descending, then by their columns: equal-score rows in one
    order whichever way they came."""
    c = rows[:, 12:20].astype(np.float32)
    score = c[:, 0]
    for t in range(1, 8):
        score = score + c[:, t]
    keys = [rows[:, k] for k in range(rows.shape[1] - 1, -1, -1)] + [-(score / np.float32(8.0))]
    return rows[np.lexsort(keys)]


def nms_differ(out, reference) -> int:
    """Images of a served (det, valid, num) whose detections are not the
    reference NMS's (`reference`: per image a dict with `rows`)."""
    det, valid, num = (o.cpu() for o in out)
    bad = 0
    for j, r in enumerate(reference):
        n = int(num[j])
        want = r["rows"].cpu().float().numpy()
        flags = valid[j]
        if n != len(want) or int(flags.sum()) != n or not bool(flags[:n].all()):
            bad += 1
            continue
        got = det[j][:n].float().numpy()
        bad += not np.array_equal(_canonical(got), _canonical(want))
    return bad


@torch.no_grad()
def gaps(served, reference) -> dict:
    """`served`: per image a (n, 28) tensor. `reference`: per image a dict
    with `all_rows` (A, 28), the reference's row of every anchor, and `idx`,
    the anchors it kept, in the same coordinates. The mean over every served
    row of every image of its gaps to its nearest anchor: `box_err_mean_px`
    (largest coordinate gap) and `conf_err_mean` (mean of the 8 tasks).
    Infinite where an image is served empty that the reference kept rows
    for."""
    box, conf = [], []
    for s, r in zip(served, reference):
        s = torch.nan_to_num(s.to(r["all_rows"].device, torch.float32), nan=float("inf"))
        if len(s) == 0:
            if len(r["idx"]):
                return dict(box_err_mean_px=float("inf"), conf_err_mean=float("inf"))
            continue
        gap = (s[:, None, :12] - r["all_rows"][None, :, :12]).abs().amax(-1)  # (n, A)
        d, a = gap.min(1)
        box.append(d)
        conf.append((s[:, 12:20] - r["all_rows"][a, 12:20]).abs().mean(1))
    box, conf = (torch.cat(v) if v else torch.zeros(1) for v in (box, conf))
    return dict(box_err_mean_px=float(box.mean()), conf_err_mean=float(conf.mean()))


def compare(served, base, reference) -> dict:
    """The forward's numbers of `served` rows (the program's, or the
    control's) against the fp32 `reference`, beside `base`, the kept rows of
    the reference computed with bf16-rounded conv inputs and weights (the
    served precision's own rounding on the same inputs): `box_err_ratio` and
    `conf_err_ratio` are served's mean gaps over base's. The ratios are
    steady from seed to seed, where the gaps themselves scale with the
    seeded weights. Only `box_err_ratio` separates the program from the
    control by the margin a limit needs; the rest are read, not judged."""
    s, b = gaps(served, reference), gaps(base, reference)
    return dict(s, box_err_ratio=s["box_err_mean_px"] / b["box_err_mean_px"],
                conf_err_ratio=s["conf_err_mean"] / b["conf_err_mean"])


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the numbers the limits name."""
    checks = [(k, numbers[k], float(v)) for k, v in limits.items()]
    return all(v <= lim for _, v, lim in checks), checks
