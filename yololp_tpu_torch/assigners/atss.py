"""ATSS label assignment as fixed-shape masked torch code (mirrors
yololp_tpu/assigners/atss.py).

Ground truths are padded to a static M and masked, so no step depends on how
many are real: masked candidate indices collapse to slot 0 and the >1 dedup
zeroes them out, which makes an image without gts all background. Runs under
`torch.no_grad()`.

Held element for element against the jitted JAX function:
- the per-level top-k nearest anchors come from a stable ascending sort, so
  that ties go to the lower index as `lax.top_k` breaks them (the grid is
  symmetric about a gt centre, so distance ties are common);
- the threshold's mean and std(ddof=1) sum the K candidates left to right
  and multiply by fp32(1/K) and fp32(1/(K-1)), as the jitted program reduces
  and divides (ops/division.py); the same on the CPU and the card;
- conflicts go to the first maximum (`argmax`), as in JAX.
`approx_topk` (lax.approx_max_k in JAX) maps to the exact selection, as
JAX runs it off the TPU, where XLA lowers approx_max_k to an exact sort.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from yololp_tpu_torch.ops.division import div_const
from yololp_tpu_torch.ops.geometry import pairwise_iou, pairwise_iou_mmdet


class ATSSResult(NamedTuple):
    target_pro: torch.Tensor          # (B, A) int32, bg = npro
    target_alp: torch.Tensor          # (B, A) int32, bg = nalp
    target_ads: torch.Tensor          # (B, A, 6) int32, bg = nads
    target_bboxes: torch.Tensor       # (B, A, 4) xyxy
    target_corners: torch.Tensor      # (B, A, 8)
    target_pro_scores: torch.Tensor   # (B, A, npro)
    target_alp_scores: torch.Tensor   # (B, A, nalp)
    target_ads_scores: torch.Tensor   # (B, A, 6, nads)
    fg_mask: torch.Tensor             # (B, A) bool


def _center_distances(gt_bboxes, anchors):
    """(B, M, A) distance gt centre <-> anchor-cell centre, and the (A, 2)
    anchor centres."""
    gt_c = (gt_bboxes[..., 0:2] + gt_bboxes[..., 2:4]) / 2.0
    ac_c = (anchors[:, 0:2] + anchors[:, 2:4]) / 2.0
    d = gt_c[:, :, None, :] - ac_c[None, None, :, :]
    return torch.sqrt((d * d).sum(-1)), ac_c


def _in_gts(ac_points, gt_bboxes, eps: float = 1e-9):
    """(B, M, A) anchor centre strictly inside the gt box."""
    lt = ac_points[None, None, :, :] - gt_bboxes[:, :, None, 0:2]
    rb = gt_bboxes[:, :, None, 2:4] - ac_points[None, None, :, :]
    deltas = torch.cat([lt, rb], -1)
    return (deltas.amin(-1) > eps).to(gt_bboxes.dtype)


def _topk_indices(x, k: int, largest: bool):
    """Indices of the k largest (or smallest) along the last axis, in order,
    ties to the lower index (lax.top_k's order): a stable sort."""
    return torch.sort(x, dim=-1, descending=largest, stable=True)[1][..., :k]


def _dedup_one_hot(idxs, n: int, mask_gt, dtype):
    """one_hot(where(mask, idxs, 0), n).sum(-2) with counts > 1 set to 0."""
    masked = torch.where(mask_gt.bool(), idxs, torch.zeros_like(idxs))
    counts = torch.zeros(*idxs.shape[:-1], n, dtype=dtype, device=idxs.device)
    counts.scatter_add_(-1, masked, torch.ones_like(masked, dtype=dtype))
    return torch.where(counts > 1, torch.zeros_like(counts), counts)


def _select_topk_candidates(distances, n_level_list: Sequence[int], mask_gt, topk: int):
    """Per-level top-k nearest anchors: (is_in_candidate (B, M, A),
    candidate_idxs (B, M, sum_l k_l) as global anchor indices)."""
    is_in, cand = [], []
    start = 0
    for n in n_level_list:
        k = min(topk, n)
        idxs = _topk_indices(distances[..., start:start + n], k, largest=False)
        cand.append(idxs + start)
        is_in.append(_dedup_one_hot(idxs, n, mask_gt, distances.dtype))
        start += n
    return torch.cat(is_in, -1), torch.cat(cand, -1)


def _sum_in_order(x):
    """Left-to-right sum over the last axis (keepdim): XLA's CPU order for
    these short rows, and the same on the card."""
    total = x[..., 0:1]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i:i + 1]
    return total


def _threshold(is_in_candidate, candidate_idxs, overlaps):
    """mean + std(ddof=1) of each gt's candidate IoUs, and the IoUs masked
    to the candidates."""
    masked_overlaps = torch.where(is_in_candidate > 0, overlaps, torch.zeros_like(overlaps))
    cand = torch.gather(masked_overlaps, -1, candidate_idxs)
    k = cand.shape[-1]
    mean = div_const(_sum_in_order(cand), k)
    centered = cand - mean
    std = torch.sqrt(div_const(_sum_in_order(centered * centered), k - 1))
    return mean + std, masked_overlaps


def _resolve_conflicts(mask_pos, overlaps):
    """Keep only the highest-IoU gt of an anchor assigned to several."""
    m = overlaps.shape[-2]
    fg = mask_pos.sum(-2)
    multi = fg[:, None, :] > 1
    is_max = F.one_hot(overlaps.argmax(-2), m).to(overlaps.dtype).transpose(-1, -2)
    mask_pos = torch.where(multi, is_max, mask_pos)
    return mask_pos.argmax(-2), mask_pos.sum(-2), mask_pos


def gather_targets(target_gt_idx, fg_pos, gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners,
                   npro: int, nalp: int, nads: int):
    """Each anchor's gt (by target_gt_idx (B, A)): class ids with background
    where not fg, boxes, corners, and the one-hot class scores."""
    def gather(x):
        idx = target_gt_idx.reshape(*target_gt_idx.shape, *([1] * (x.dim() - 2)))
        return torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))

    def bg(t, bg_idx):
        return torch.where(fg_pos, t, torch.full_like(t, bg_idx)).to(torch.int32)

    target_pro = bg(gather(gt_pro.to(torch.int32)), npro)
    target_alp = bg(gather(gt_alp.to(torch.int32)), nalp)
    target_ads = torch.where(fg_pos[..., None], gather(gt_ads.to(torch.int32)),
                             torch.full_like(gt_ads[:, :1].to(torch.int32), nads)).to(torch.int32)
    # one-hot with the background class dropped (an id of -1 gives no class)
    pro_scores = _one_hot(target_pro, npro)
    alp_scores = _one_hot(target_alp, nalp)
    ads_scores = _one_hot(target_ads, nads)
    return (target_pro, target_alp, target_ads, gather(gt_bboxes), gather(gt_corners),
            pro_scores, alp_scores, ads_scores)


def _one_hot(ids, n: int):
    """jax.nn.one_hot(ids, n + 1)[..., :n] in fp32: ids outside [0, n) (the
    background n, or -1) give a zero row."""
    classes = torch.arange(n, device=ids.device, dtype=ids.dtype)
    return (ids[..., None] == classes).to(torch.float32)


@torch.no_grad()
def atss_assign(anchors, n_level_list, gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners,
                mask_gt, pd_bboxes=None, topk: int = 9, npro: int = 31, nalp: int = 24,
                nads: int = 37, approx_topk: bool = False) -> ATSSResult:
    """anchors (A, 4) grid-cell boxes in pixels; gt_pro/gt_alp (B, M), gt_ads
    (B, M, 6), gt_bboxes (B, M, 4) xyxy pixels, gt_corners (B, M, 8), mask_gt
    (B, M, 1) 1.0 for real gts; pd_bboxes (B, A, 4) detached predicted xyxy
    pixels or None. `approx_topk` maps to the exact selection."""
    del approx_topk  # off the TPU, XLA lowers lax.approx_max_k to an exact sort
    bsz, n_max = gt_bboxes.shape[:2]
    n_anchors = anchors.shape[0]

    overlaps = pairwise_iou_mmdet(gt_bboxes.reshape(-1, 4), anchors).reshape(
        bsz, n_max, n_anchors)
    distances, ac_points = _center_distances(gt_bboxes, anchors)

    is_in_candidate, candidate_idxs = _select_topk_candidates(
        distances, n_level_list, mask_gt, topk)
    thr, iou_candidates = _threshold(is_in_candidate, candidate_idxs, overlaps)

    is_pos = torch.where(iou_candidates > thr, is_in_candidate,
                         torch.zeros_like(is_in_candidate))
    mask_pos = is_pos * _in_gts(ac_points, gt_bboxes) * mask_gt

    target_gt_idx, fg, mask_pos = _resolve_conflicts(mask_pos, overlaps)
    fg_pos = fg > 0
    (target_pro, target_alp, target_ads, target_bboxes, target_corners,
     pro_scores, alp_scores, ads_scores) = gather_targets(
        target_gt_idx, fg_pos, gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners, npro, nalp, nads)

    if pd_bboxes is not None:
        ious = pairwise_iou(gt_bboxes, pd_bboxes) * mask_pos
        ious = ious.amax(-2)[..., None]
        pro_scores = pro_scores * ious
        alp_scores = alp_scores * ious
        ads_scores = ads_scores * ious[..., None, :]

    return ATSSResult(target_pro, target_alp, target_ads, target_bboxes, target_corners,
                      pro_scores, alp_scores, ads_scores, fg_pos)
