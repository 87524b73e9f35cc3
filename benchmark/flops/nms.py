"""Operations and bytes that one greedy-NMS launch needs for its inputs.

Per image of K score-sorted candidates: each kept box is tested against
every later valid candidate (15 operations an IoU test: 2 max, 2 min, 2
sub, 2 clip, 1 mul, 2 add, 1 sub, 1 div, 1 compare) and every box's area
costs 5; the boxes (16 bytes) and scores (4) are read once and the keep
flag (1) written once. The keep masks are the reference's (reference/nms.py)
on the same inputs, so the count is what these inputs need, not the most
they could."""

from __future__ import annotations

IOU_PAIR_OPS, AREA_OPS = 15, 5
BYTES_PER_BOX = 16 + 4 + 1


def nms_work(keeps, n_valid):
    """(operations, bytes) of one launch over images with keep masks
    `keeps` (each a bool sequence of length K) and `n_valid` valid
    candidates each."""
    ops = nbytes = 0
    for keep, nv in zip(keeps, n_valid):
        k = len(keep)
        ops += AREA_OPS * k + IOU_PAIR_OPS * sum(max(nv - 1 - i, 0) for i, kept in enumerate(keep) if kept)
        nbytes += BYTES_PER_BOX * k
    return ops, nbytes
