"""The LP training loss as fixed-shape masked torch code (mirrors
yololp_tpu/losses/loss.py).

Targets arrive padded to (B, M, 20) with a mask, so no step syncs the host
or depends on how many boxes are real. Returns (total, items[7]) with items =
[iou, corner, dfl, cls, pro, alp, ads/6]; `with_fg` adds the fg mask.

In a process group of more than one rank each rank holds its shard of the
global batch: the denominators (the summed target scores) are summed over
the ranks, so each rank's total and items are its share of the global
batch's, and the ranks' shares add up to the single-process loss.

Held against the jitted JAX function: its divisions by a constant are
reciprocal multiplies (`ads / 6`, ops/division.py; the others divide by
powers of two, where both agree), its clips split a tie's gradient in half
where `torch.clamp` passes it whole (the VFL clips a saturated sigmoid at
1e-12 and 1: the tests compare gradients away from the ends).
`approx_topk=True` maps to the exact selection, as JAX runs it off the TPU,
where XLA lowers lax.approx_max_k to an exact sort.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from yololp_tpu_torch.assigners.atss import ATSSResult, _one_hot, atss_assign
from yololp_tpu_torch.models.effidehead import HeadTrainOutput
from yololp_tpu_torch.ops.anchors import anchors_train
from yololp_tpu_torch.ops.division import div_const
from yololp_tpu_torch.ops.geometry import (bbox2dist, dist2bbox, dist2cor, iou_loss as iou_loss_fn,
                                           xywh2xyxy)
from yololp_tpu_torch.parallel.mesh import global_sum


def varifocal_loss(pred_score, gt_score, label, alpha=0.75, gamma=2.0):
    """Sum-reduced varifocal loss, in fp32 (float64 for float64 scores)."""
    wide = torch.promote_types(pred_score.dtype, torch.float32)
    pred = pred_score.to(wide)
    gt = gt_score.to(wide)
    weight = alpha * torch.pow(pred, gamma) * (1.0 - label) + gt * label
    eps = 1e-12
    bce = -(gt * torch.log(pred.clamp(eps, 1.0)) + (1.0 - gt) * torch.log((1.0 - pred).clamp(eps, 1.0)))
    return (bce * weight).sum()


def wing_loss(x, t, w=5.0, e=2.0):
    """Elementwise wing loss; zero weight where t == -1."""
    c = w - w * torch.log(torch.tensor(1.0 + w / e))  # fp32, as jnp.log of a constant
    weight = torch.where(t == -1.0, 0.0, 1.0)
    diff = weight * (x - t)
    abs_diff = diff.abs()
    return torch.where(abs_diff < w, w * torch.log(1.0 + abs_diff / e), abs_diff - c)


def _df_loss(pred_dist, target, reg_max: int):
    """Distribution focal loss. pred_dist (..., 4, R+1), target (..., 4) in
    [0, reg_max); returns (..., 1)."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist, dim=-1)

    def take(idx):
        return torch.gather(logp, -1, idx.clamp(0, reg_max)[..., None])[..., 0]

    loss = -(take(tl) * wl + take(tr) * wr)
    return loss.mean(-1, keepdim=True)


class LossConfig(NamedTuple):
    img_size: Tuple[int, int] = (640, 640)
    strides: Tuple[int, ...] = (8, 16, 32)
    npro: int = 31
    nalp: int = 24
    nads: int = 37
    use_dfl: bool = False
    reg_max: int = 0
    iou_type: str = "giou"
    grid_cell_size: float = 5.0
    grid_cell_offset: float = 0.5
    topk: int = 9
    assigner: str = "atss"   # 'atss' | 'tal'
    # lax.approx_max_k in the JAX package: an exact sort off the TPU, as here
    approx_topk: bool = False
    tal_topk: int = 13
    tal_alpha: float = 1.0
    tal_beta: float = 6.0
    w_class: float = 3.0
    w_iou: float = 2.5
    w_corner: float = 1.0
    w_dfl: float = 0.5


def _norm(loss, total):
    """loss / total where total > 0, else loss (the JAX jnp.where). The
    denominator is selected rather than the quotient, so that the branch not
    taken (a division by 0) puts no NaN into the gradient."""
    return loss / torch.where(total > 0, total, torch.ones_like(total))


class Assignment(NamedTuple):
    """The assigner's result with the decoded predictions it was made from."""

    res: ATSSResult
    pred_bboxes: torch.Tensor      # (B, A, 4) xyxy, grid units
    pred_corners: torch.Tensor     # (B, A, 8), grid units
    anchor_points_s: torch.Tensor  # (A, 2), grid units
    stride_tensor: torch.Tensor    # (A, 1)


def prepare_targets(gt_labels, gt_mask, img_size, device):
    """(B, M, 20) normalized labels and their (B, M) mask -> gt_pro, gt_alp
    (B, M), gt_ads (B, M, 6), gt_bboxes (B, M, 4) xyxy pixels (zero where
    masked), gt_corners (B, M, 8) pixels and mask_gt (B, M, 1)."""
    gt_labels = gt_labels.to(device, torch.float32)
    scale = torch.tensor([img_size[1], img_size[0]] * 6, dtype=torch.float32, device=device)
    pts = gt_labels[..., 8:20] * scale
    gt_bboxes = xywh2xyxy(pts[..., 0:4])
    mask_gt = gt_mask.to(device, torch.float32)[..., None]
    mask_gt = mask_gt * (gt_bboxes.sum(-1, keepdim=True) > 0).float()
    return (gt_labels[..., 0], gt_labels[..., 1], gt_labels[..., 2:8], gt_bboxes * mask_gt,
            pts[..., 4:12], mask_gt)


def assign(outputs: HeadTrainOutput, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
           cfg: LossConfig) -> Assignment:
    """Decode the predictions in grid units and assign targets (no gradient
    flows into the assignment)."""
    dev = outputs.reg.device
    anchors, anchor_points, n_list, stride_tensor = anchors_train(
        cfg.img_size, cfg.strides, cfg.grid_cell_size, cfg.grid_cell_offset, device=dev)
    gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners, mask_gt = prepare_targets(
        gt_labels, gt_mask, cfg.img_size, dev)

    anchor_points_s = anchor_points / stride_tensor
    reg = outputs.reg
    if cfg.use_dfl:
        b, a, _ = reg.shape
        prob = torch.softmax(reg.reshape(b, a, 4, cfg.reg_max + 1), -1)
        proj = torch.arange(cfg.reg_max + 1, dtype=prob.dtype, device=dev)
        reg_dist = torch.einsum("bakr,r->bak", prob, proj)
    else:
        reg_dist = reg
    pred_bboxes = dist2bbox(reg_dist, anchor_points_s)
    pred_corners = dist2cor(outputs.cor, anchor_points_s)

    if cfg.assigner == "tal":
        from yololp_tpu_torch.assigners.tal import tal_assign

        res = tal_assign(outputs.pro.detach(), pred_bboxes.detach() * stride_tensor,
                         anchor_points, gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners, mask_gt,
                         topk=cfg.tal_topk, npro=cfg.npro, nalp=cfg.nalp, nads=cfg.nads,
                         alpha=cfg.tal_alpha, beta=cfg.tal_beta, approx_topk=cfg.approx_topk)
    else:
        res = atss_assign(anchors, tuple(n_list), gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners,
                          mask_gt, pred_bboxes.detach() * stride_tensor, topk=cfg.topk,
                          npro=cfg.npro, nalp=cfg.nalp, nads=cfg.nads,
                          approx_topk=cfg.approx_topk)
    return Assignment(res, pred_bboxes, pred_corners, anchor_points_s, stride_tensor)


def loss_terms(outputs: HeadTrainOutput, asg: Assignment, cfg: LossConfig,
               with_fg: bool = False):
    """The loss of `outputs` against an assignment: (total, items[7])."""
    res, reg = asg.res, outputs.reg
    fg = res.fg_mask.float()
    target_bboxes = res.target_bboxes / asg.stride_tensor
    target_corners = res.target_corners / asg.stride_tensor

    # ---- classification: 8 varifocal losses ----
    loss_pro = varifocal_loss(outputs.pro, res.target_pro_scores, _one_hot(res.target_pro, cfg.npro))
    loss_alp = varifocal_loss(outputs.alp, res.target_alp_scores, _one_hot(res.target_alp, cfg.nalp))
    one_hot_ads = _one_hot(res.target_ads, cfg.nads)
    # the denominators: sums over the global batch (over the ranks of a
    # process group, the partitioned JAX program's sums), in one collective
    sums = global_sum(torch.stack([res.target_pro_scores.sum(), res.target_alp_scores.sum()]
                                  + [res.target_ads_scores[:, :, i].sum() for i in range(6)]))
    pro_sum, alp_sum = sums[0], sums[1]
    ads_losses, ads_sums = [], []
    for i in range(6):
        li = varifocal_loss(outputs.ads[:, :, i], res.target_ads_scores[:, :, i],
                            one_hot_ads[:, :, i])
        si = sums[2 + i]
        ads_losses.append(_norm(li, si))
        ads_sums.append(si)

    loss_pro = _norm(loss_pro, pro_sum)
    loss_alp = _norm(loss_alp, alp_sum)
    loss_ads = sum(ads_losses)
    loss_cls = (loss_pro + loss_alp + loss_ads) / 8.0
    target_scores_sum = (pro_sum + alp_sum + sum(ads_sums)) / 8.0

    # ---- box IoU (+ DFL) loss, masked full-shape ----
    per_anchor_score = (res.target_pro_scores.sum(-1) + res.target_alp_scores.sum(-1)
                        + res.target_ads_scores.sum((-1, -2))) / 8.0
    bbox_weight = per_anchor_score * fg
    iou_l = iou_loss_fn(asg.pred_bboxes, target_bboxes, iou_type=cfg.iou_type, eps=1e-10)[..., 0]
    loss_iou = _norm((iou_l * bbox_weight).sum(), target_scores_sum)

    if cfg.use_dfl:
        b, a, _ = reg.shape
        pd = reg.reshape(b, a, 4, cfg.reg_max + 1)
        target_ltrb = bbox2dist(asg.anchor_points_s, target_bboxes, cfg.reg_max)
        dfl = _df_loss(pd, target_ltrb, cfg.reg_max)[..., 0]
        loss_dfl = _norm((dfl * bbox_weight).sum(), target_scores_sum)
    else:
        loss_dfl = reg.sum() * 0.0

    # ---- corner wing loss ----
    wl = wing_loss(asg.pred_corners, target_corners).sum(-1)
    loss_cor = _norm((wl * fg).sum(), target_scores_sum) / 8.0

    total = (cfg.w_class * loss_cls + cfg.w_iou * loss_iou + cfg.w_corner * loss_cor
             + cfg.w_dfl * loss_dfl)
    items = torch.stack([cfg.w_iou * loss_iou, cfg.w_corner * loss_cor, cfg.w_dfl * loss_dfl,
                         cfg.w_class * loss_cls, loss_pro, loss_alp,
                         div_const(loss_ads, 6.0)]).detach()
    if with_fg:
        return total, items, res.fg_mask
    return total, items


def compute_loss(outputs: HeadTrainOutput, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                 cfg: LossConfig, with_fg: bool = False):
    """outputs: the head's train output (scores sigmoided, reg/cor raw).
    gt_labels: (B, M, 20) [pro, alp, ads0..5, cx, cy, w, h, x1..y4], coords
    normalized to [0, 1], class slots of padded rows -1 and coords 0.
    gt_mask: (B, M) 1.0 for real boxes."""
    return loss_terms(outputs, assign(outputs, gt_labels, gt_mask, cfg), cfg, with_fg)
