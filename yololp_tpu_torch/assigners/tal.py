"""Task-aligned (TAL) label assignment as fixed-shape masked torch code
(mirrors yololp_tpu/assigners/tal.py), the alternative to ATSS
(`LossConfig(assigner="tal")`).

align metric = score(gt province class)^alpha * IoU(gt, pred)^beta; the
per-gt top-k anchors by that metric (a stable sort: ties to the lower index,
as lax.top_k), restricted to anchors inside the gt box; conflicts to the
highest IoU; all 8 task scores normalized by the per-gt align metric. Runs
under `torch.no_grad()`. `approx_topk` maps to the exact selection, as JAX
runs it off the TPU, where XLA lowers lax.approx_max_k to an exact sort.
"""

from __future__ import annotations

import torch

from yololp_tpu_torch.assigners.atss import (ATSSResult, _dedup_one_hot, _in_gts,
                                             _resolve_conflicts, _topk_indices,
                                             gather_targets)
from yololp_tpu_torch.ops.geometry import pairwise_iou


def _pow(x, e: float):
    """x ** e rounded once to fp32 (computed in fp64): the same on the CPU
    and the card. XLA's CPU pow is an approximation of its own; it differs
    from this in the last bit on ~0.06% of values."""
    return torch.pow(x.double(), e).to(x.dtype)


def _topk_mask(metrics, topk: int, mask_gt):
    """(B, M, A) metrics -> one-hot mask of each gt's top-k anchors, with the
    >1 dedup."""
    a = metrics.shape[-1]
    idxs = _topk_indices(metrics, min(topk, a), largest=True)
    return _dedup_one_hot(idxs, a, mask_gt, metrics.dtype)


@torch.no_grad()
def tal_assign(pd_pro_scores, pd_bboxes, anc_points, gt_pro, gt_alp, gt_ads, gt_bboxes,
               gt_corners, mask_gt, topk: int = 13, npro: int = 31, nalp: int = 24,
               nads: int = 37, alpha: float = 1.0, beta: float = 6.0, eps: float = 1e-9,
               approx_topk: bool = False) -> ATSSResult:
    """pd_pro_scores (B, A, npro) sigmoided, pd_bboxes (B, A, 4) detached
    xyxy pixels, anc_points (A, 2) pixels; gts as for atss_assign."""
    del approx_topk  # off the TPU, XLA lowers lax.approx_max_k to an exact sort
    gt_idx = gt_pro.to(torch.int32).clamp(0, npro - 1).long()          # (B, M)
    # each anchor's score for each gt's province class: (B, M, A)
    bbox_scores = torch.gather(pd_pro_scores.transpose(1, 2), 1,
                               gt_idx[..., None].expand(-1, -1, pd_pro_scores.shape[1]))
    overlaps = pairwise_iou(gt_bboxes, pd_bboxes)
    align_metric = _pow(bbox_scores, alpha) * _pow(overlaps, beta)

    in_gts = _in_gts(anc_points, gt_bboxes)
    mask_pos = _topk_mask(align_metric * in_gts, topk, mask_gt) * in_gts * mask_gt

    target_gt_idx, fg, mask_pos = _resolve_conflicts(mask_pos, overlaps)
    fg_pos = fg > 0
    (target_pro, target_alp, target_ads, target_bboxes, target_corners,
     pro_scores, alp_scores, ads_scores) = gather_targets(
        target_gt_idx, fg_pos, gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners, npro, nalp, nads)

    # align-metric normalization of all 8 task scores
    am = align_metric * mask_pos
    pos_align = am.amax(-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (am * pos_overlap / (pos_align + eps)).amax(-2)[..., None]
    return ATSSResult(target_pro, target_alp, target_ads, target_bboxes, target_corners,
                      pro_scores * norm, alp_scores * norm, ads_scores * norm[..., None, :],
                      fg_pos)
