"""Fixed-shape NMS over the 290-column LP prediction tensor (mirrors
yololp_tpu/ops/nms.py).

Column layout in: [0:4] bbox xywh (pixels), [4] obj (==1), [5:13] corners,
[13:44] province(31), [44:68] alphabet(24), [68:290] 6 x characters(37).

Output layout (28 cols): [0:4] xyxy, [4:12] corners, [12:20] per-task
confidences (pro, alp, ad0..ad5), [20:28] per-task argmax class ids (float).

Steps: mean-of-8 confidence gate (boxes, the 8 task maxima and argmaxima,
the score and the gate in one pass: the op `yololp_torch::nms_gate`,
ops/cuda_nms_gate.py, a CUDA kernel on the card), top-k of `pre_nms_topk` by
a stable descending sort (ties go to the lower index, as lax.top_k), the
greedy keep-mask (a CUDA kernel on the card, ops/cuda_nms.py) and stable
compaction, each a span of its own (`nms.gate`, `nms.topk`, `nms.keep`,
`nms.compact` inside `nms`; utils/profiler.py). The counters `nms.gated` and
`nms.slots` add, per image, the keep step's slots that hold an anchor at or
above the gate (min(gated anchors, K)) and all its K slots; `nms.gate_calls`
counts the gates and `nms.gate_fused` those that took the op.

The JAX function's two variants are here too. `candidate_selector="approx"`
names lax.approx_max_k, which on a TPU is a PartialReduce with recall target
0.95 and which XLA lowers to an exact sort on every other backend: off the
TPU it returns lax.top_k's values and indices, ties included. So both
selectors take the same exact, stable top-K here, and give the same
candidates bit for bit as the JAX function run anywhere but a TPU.
`nms_iters=N > 0` replaces the exact keep-mask by N steps of the parallel
update map (cuda_nms.greedy_nms_mask_bounded), as JAX's fori_loop does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yololp_tpu_torch.ops import cuda_nms_gate
from yololp_tpu_torch.ops.cuda_nms import greedy_nms_mask
from yololp_tpu_torch.utils.profiler import annotate, count, recording

SELECTORS = ("topk", "approx")


def _gate_takes_op(prediction: torch.Tensor) -> bool:
    """Whether the gate runs as the op `yololp_torch::nms_gate`: always on
    the card (the kernel, which raises on a decode it does not take), and on
    the CPU for a contiguous fp32 (B, A, 290) decode (its plain version).
    Other CPU input (float64, a strided view) runs the plain version
    directly."""
    if prediction.device.type == "cuda":
        return True
    return (prediction.device.type == "cpu" and prediction.dtype == torch.float32
            and prediction.dim() == 3 and prediction.shape[-1] == cuda_nms_gate.COLS
            and prediction.is_contiguous())


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

    The JAX function takes approx_max_k when its selector is "approx" and
    K < A, else top_k; off the TPU both are this sort.

    Returns box_k (B, K, 4) xyxy, score_k (B, K) sorted descending (0 where
    gated out) and rest_k (B, K, 24): corners, the 8 task confidences and
    the 8 task class ids (as float) of each candidate.
    """
    dev = prediction.device
    fused = _gate_takes_op(prediction)
    with annotate("nms.gate", dev):
        gate = cuda_nms_gate.nms_gate if fused else cuda_nms_gate.nms_gate_plain
        box, gated_score, rest, passed = gate(prediction, conf_thres, compat_ad4_bug)

    k = min(pre_nms_topk, prediction.shape[1])
    if recording():
        # the slots of the keep step that hold a gated anchor, and all its slots
        count("nms.gated", passed.sum(1).clamp_(max=k).sum())
        count("nms.slots", prediction.shape[0] * k)
        count("nms.gate_calls", 1)
        if fused:
            count("nms.gate_fused", 1)
    with annotate("nms.topk", dev):
        top_score, top_idx = torch.sort(gated_score, dim=1, descending=True, stable=True)
        top_score, top_idx = top_score[:, :k].contiguous(), top_idx[:, :k]
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
    `candidate_selector`: "topk", or "approx", which selects the same
    candidates off the TPU (the module's docstring). `nms_iters`: 0 for the
    exact keep-mask (the CUDA kernel on the card), N > 0 for JAX's fixed
    bound of N update steps.
    """
    if candidate_selector not in SELECTORS:
        raise ValueError(f"candidate_selector {candidate_selector!r}: one of {SELECTORS}")
    dev = prediction.device
    with annotate("nms", dev):
        box_k, score_k, rest_k = select_candidates(prediction, conf_thres, pre_nms_topk,
                                                   compat_ad4_bug)
        with annotate("nms.keep", dev):
            keep = greedy_nms_mask(box_k, score_k, iou_thres, iters=nms_iters)

        with annotate("nms.compact", dev):
            order = stable_compact_order(keep, max_det)
            det = torch.cat([_take(box_k, order), _take(rest_k, order)], -1)
            valid = torch.gather(keep, 1, order)
            det = torch.where(valid[..., None], det, torch.zeros_like(det))
            return det, valid, valid.sum(-1).to(torch.int32)
