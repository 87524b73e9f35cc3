"""Greedy NMS keep-mask: the CUDA kernel csrc/greedy_nms.cu and its plain
PyTorch versions.

`greedy_nms_mask` calls the custom op `yololp_torch::greedy_nms_mask`
(ops/library.py), which runs the kernel on a CUDA tensor and the plain
version on a CPU tensor; on a CUDA tensor it launches the kernel or raises.
`_build.launches("greedy_nms")` counts the kernel's launches.

The plain version mirrors the JAX default, the fixpoint of
yololp_tpu/ops/nms.py:44-79: keep_i = valid_i and no kept j < i with
IoU(j, i) > thres, iterated to convergence. The recurrence has a unique
solution, so the fixpoint is the exact sequential greedy answer. It stays the
kernel's oracle. `greedy_nms_mask(..., iters=N)` with N > 0 is the JAX
package's fixed bound instead (`greedy_nms_mask_bounded`, plain PyTorch ops
on either device): N steps of the same update, exact only for suppression
chains of depth < N.

The kernel computes the same answer in two steps, each mirrored here in
plain PyTorch so the CPU tests can hold the design to the JAX package:
`suppression_words_plain` packs the upper-triangular suppression test into
32-bit words (what a thread-block cluster builds on the card), and
`walk_kept_rows_plain` walks those words one kept row at a time, word by
word (what one warp does).
"""

from __future__ import annotations

import ctypes

import torch

from yololp_tpu_torch.ops import _build
from yololp_tpu_torch.ops.geometry import pairwise_iou

MAX_K = 1024  # the kernel's walk holds ceil(K/32) <= 32 words, one a lane

_LAUNCH = _build.Kernel("greedy_nms", "greedy_nms_mask_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_float])


def _suppression_matrix(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, K) bool: row j suppresses column i > j when IoU(j, i) > thres."""
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    return (pairwise_iou(boxes, boxes) > iou_thres) & (idx[:, None] < idx[None, :])


def _update(sup: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """One step of the parallel update map: valid and no kept j < i suppresses i."""
    return valid & ~(sup & keep[..., :, None]).any(dim=-2)


def greedy_nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """boxes (B, K, 4) score-sorted xyxy, scores (B, K) -> bool keep (B, K)."""
    sup = _suppression_matrix(boxes, iou_thres)
    valid = scores > 0.0
    keep = valid
    for _ in range(boxes.shape[-2]):
        new = _update(sup, valid, keep)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def greedy_nms_mask_bounded(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                            iters: int) -> torch.Tensor:
    """The JAX package's fixed bound (`greedy_nms_mask(iters=N)`, its
    `fori_loop`): N steps of the update map from keep = valid, with no test
    for convergence, so no step waits on the host. A suppression chain deeper
    than N is not resolved: the mask then differs from the exact one. Plain
    PyTorch ops on the tensors' device; JAX computes it in XLA, outside any
    Pallas kernel."""
    sup = _suppression_matrix(boxes, iou_thres)
    valid = scores > 0.0
    keep = valid
    for _ in range(iters):
        keep = _update(sup, valid, keep)
    return keep


def suppression_words_plain(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """boxes (B, K, 4) score-sorted xyxy -> (B, K, ceil(K/32)) int64 holding
    32-bit words: bit c of word w in row i is set when j = 32w + c > i and
    IoU(i, j) > thres. Words at or left of the diagonal are 0."""
    b, k = boxes.shape[:2]
    w = -(-k // 32)
    sup = _suppression_matrix(boxes, iou_thres)
    bits = torch.zeros((b, k, 32 * w), dtype=torch.int64, device=boxes.device)
    bits[..., :k] = sup.long()
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=boxes.device)
    return (bits.view(b, k, w, 32) * weights).sum(-1)


def walk_kept_rows_plain(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The kernel's walk over `suppression_words_plain` words (B, K, W) and
    the valid mask (B, K): one step per kept box. List entry l plays lane l,
    which holds keep-word l (the valid boxes, cleared as kept rows suppress
    them). The walk goes word by word: the lowest bit over the lanes above
    the current word is the first kept box i of the next word w that holds
    one (every earlier kept row has been applied, so i is kept); inside
    word w each next kept box is the lowest bit left in a copy of the word,
    `cur`, after row i has cleared it. Returns bool keep (B, K)."""
    b, k, w = words.shape
    rows = words.tolist()
    flags = valid.tolist()
    keep = []
    for n in range(b):
        kw = [sum(1 << c for c in range(32) if 32 * l + c < k and flags[n][32 * l + c])
              for l in range(w)]
        word = -1
        while True:
            cand = [32 * l + (p & -p).bit_length() - 1 for l, p in enumerate(kw) if l > word and p]
            if not cand:
                break
            i = min(cand)
            word = i >> 5
            cur = kw[word]
            while True:
                row = rows[n][i]
                for l in range(word, w):
                    kw[l] &= ~row[l]
                cur &= (cur - 1) & ~row[word]
                if not cur:
                    break
                i = 32 * word + (cur & -cur).bit_length() - 1
        keep.append([bool(kw[j >> 5] >> (j & 31) & 1) for j in range(k)])
    return torch.tensor(keep, dtype=torch.bool, device=words.device).view(b, k)


def _check_shapes(boxes: torch.Tensor, scores: torch.Tensor, *_):
    """boxes (B, K, 4) and scores (B, K) (the op's threshold takes any value)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2]:
        raise ValueError(f"scores must be (B, K) = {tuple(boxes.shape[:2])}, "
                         f"got {tuple(scores.shape)}")


def _check(boxes: torch.Tensor, scores: torch.Tensor):
    """What the kernel takes."""
    _check_shapes(boxes, scores)
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got {boxes.dtype}, {scores.dtype}")
    if scores.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    if boxes.shape[1] > MAX_K:
        raise ValueError(f"K = {boxes.shape[1]} exceeds the kernel's limit of {MAX_K}")
    if boxes.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {boxes.device}")


def greedy_nms_mask_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_thres: float) -> torch.Tensor:
    """Launch csrc/greedy_nms.cu on CUDA tensors; raise on any refusal."""
    _check(boxes, scores)
    b, k = scores.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    _LAUNCH.launch(boxes.device, boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), b, k,
                   float(iou_thres))
    return keep


def greedy_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                    iters: int = 0) -> torch.Tensor:
    """Greedy keep-mask, with the JAX function's signature. iters=0: the
    exact mask, the op `yololp_torch::greedy_nms_mask` (ops/library.py): the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    iters > 0: the fixed bound, `greedy_nms_mask_bounded`."""
    if iters:
        return greedy_nms_mask_bounded(boxes, scores, iou_thres, iters)
    return torch.ops.yololp_torch.greedy_nms_mask(boxes, scores, float(iou_thres))


OPS = (_build.Op("greedy_nms_mask(Tensor boxes, Tensor scores, float iou_thres) -> Tensor",
                 "greedy_nms", _check_shapes, greedy_nms_mask_plain, greedy_nms_mask_cuda,
                 lambda boxes, scores, iou_thres: scores.new_empty(scores.shape,
                                                                   dtype=torch.bool)),)
