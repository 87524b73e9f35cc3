"""Fixed-shape NMS over the 290-column LP prediction tensor (mirrors
yololp_tpu/ops/nms.py).

Column layout in: [0:4] bbox xywh (pixels), [4] obj (==1), [5:13] corners,
[13:44] province(31), [44:68] alphabet(24), [68:290] 6 x characters(37).

Output layout (28 cols): [0:4] xyxy, [4:12] corners, [12:20] per-task
confidences (pro, alp, ad0..ad5), [20:28] per-task argmax class ids (float).

Steps: mean-of-8 confidence gate, top-k of `pre_nms_topk` by a stable
descending sort (ties go to the lower index, as lax.top_k), the greedy
keep-mask (a CUDA kernel on the card, ops/cuda_nms.py) and stable compaction.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yololp_tpu_torch.ops.cuda_nms import greedy_nms_mask
from yololp_tpu_torch.ops.geometry import xywh2xyxy

NPRO, NALP, NADS = 31, 24, 37


def _split_scores(cls):
    """(..., 276) -> list of 8 per-task score tensors."""
    out = [cls[..., :NPRO], cls[..., NPRO:NPRO + NALP]]
    base = NPRO + NALP
    for i in range(6):
        out.append(cls[..., base + i * NADS: base + (i + 1) * NADS])
    return out


def _sum_in_order(confs: torch.Tensor, cols) -> torch.Tensor:
    """Left-to-right sum of the given columns of (..., 8) confs: the order in
    which XLA's CPU reduction sums them. A device reduction may sum in another
    order, and a last-bit difference in a score can move the gate or swap two
    near-tied candidates, so the sum is spelled out."""
    cols = list(cols)
    total = confs[..., cols[0]]
    for c in cols[1:]:
        total = total + confs[..., c]
    return total


def stable_compact_order(keep: torch.Tensor, max_det: int) -> torch.Tensor:
    """Order that moves kept slots to the front, preserving relative order:
    argsort(~keep, stable)[..., :max_det], built from two cumsums and one
    scatter."""
    k = keep.shape[-1]
    ck = torch.cumsum(keep, dim=-1)
    n_kept = ck[..., -1:]
    dest = torch.where(keep, ck - 1, n_kept + torch.cumsum(~keep, dim=-1) - 1)
    src = torch.arange(k, device=keep.device).expand_as(dest)
    order = torch.zeros_like(dest).scatter_(-1, dest, src)
    return order[..., :max_det]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows `idx` (B, K) along axis 1 of t (B, A) or (B, A, C)."""
    if t.dim() == 3:
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))
    return torch.gather(t, 1, idx)


def select_candidates(prediction: torch.Tensor, conf_thres: float, pre_nms_topk: int,
                      compat_ad4_bug: bool = False):
    """Gate and rank the anchors of a (B, A, 290) decode; keep the top
    K = min(pre_nms_topk, A) of each image.

    Returns box_k (B, K, 4) xyxy, score_k (B, K) sorted descending (0 where
    gated out) and rest_k (B, K, 24): corners, the 8 task confidences and
    the 8 task class ids (as float) of each candidate.
    """
    box = xywh2xyxy(prediction[..., :4])
    obj = prediction[..., 4:5]
    cls = prediction[..., 13:] * obj  # conf = obj_conf * cls_conf

    task_scores = _split_scores(cls)
    confs = torch.stack([t.amax(dim=-1) for t in task_scores], -1)    # (B, A, 8)
    preds = torch.stack([t.argmax(dim=-1) for t in task_scores], -1)  # first max

    score = _sum_in_order(confs, range(8)) / 8.0  # NMS ranking score
    if compat_ad4_bug:
        # the reference sums ad4 twice and omits ad5
        mask_conf = _sum_in_order(confs, (0, 1, 2, 3, 4, 5, 6, 6)) / 8.0
    else:
        mask_conf = score
    gated_score = torch.where(mask_conf >= conf_thres, score, torch.zeros_like(score))

    k = min(pre_nms_topk, prediction.shape[1])
    top_score, top_idx = torch.sort(gated_score, dim=1, descending=True, stable=True)
    top_score, top_idx = top_score[:, :k].contiguous(), top_idx[:, :k]
    rest = torch.cat([prediction[..., 5:13], confs, preds.float()], -1)
    return _take(box, top_idx), top_score, _take(rest, top_idx)


def non_max_suppression(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 512,
    compat_ad4_bug: bool = False,
    nms_iters: int = 0,
    candidate_selector: str = "topk",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched fixed-shape NMS of a (B, A, 290) decode.

    Returns detections (B, N, 28) zero-padded, valid (B, N) bool and
    num_valid (B,) int32, with N = min(max_det, min(pre_nms_topk, A)).
    `nms_iters` (a fixed fixpoint bound) and the "approx" selector
    (lax.approx_max_k) of the JAX function are not ported and raise.
    """
    if candidate_selector != "topk":
        raise NotImplementedError(
            f"candidate_selector {candidate_selector!r}: only 'topk' is ported")
    if nms_iters:
        raise NotImplementedError("nms_iters: the keep-mask is always exact")
    box_k, score_k, rest_k = select_candidates(prediction, conf_thres, pre_nms_topk,
                                               compat_ad4_bug)
    keep = greedy_nms_mask(box_k, score_k, iou_thres)

    order = stable_compact_order(keep, max_det)
    det = torch.cat([_take(box_k, order), _take(rest_k, order)], -1)
    valid = torch.gather(keep, 1, order)
    det = torch.where(valid[..., None], det, torch.zeros_like(det))
    return det, valid, valid.sum(-1).to(torch.int32)
