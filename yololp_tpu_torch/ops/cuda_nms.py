"""Greedy NMS keep-mask: the CUDA kernel csrc/greedy_nms.cu and its plain
PyTorch version.

`greedy_nms_mask` runs the kernel on a CUDA tensor and the plain version on a
CPU tensor; on a CUDA tensor it launches the kernel or raises. `launches`
counts the kernel's launches.

The plain version mirrors the JAX default, the fixpoint of
yololp_tpu/ops/nms.py:44-79: keep_i = valid_i and no kept j < i with
IoU(j, i) > thres, iterated to convergence. The recurrence has a unique
solution, so the fixpoint is the exact sequential greedy answer, which the
kernel computes with one serial walk.
"""

from __future__ import annotations

import ctypes

import torch

from yololp_tpu_torch.ops import _build
from yololp_tpu_torch.ops.geometry import pairwise_iou

MAX_K = 1024  # the kernel's bitmask holds ceil(K/32) <= 32 words a row

launches = 0


def greedy_nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """boxes (B, K, 4) score-sorted xyxy, scores (B, K) -> bool keep (B, K)."""
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(k, device=boxes.device)
    higher = idx[:, None] < idx[None, :]  # row j suppresses col i > j
    sup_matrix = (iou > iou_thres) & higher
    valid = scores > 0.0
    keep = valid
    for _ in range(k):
        suppressed = (sup_matrix & keep[..., :, None]).any(dim=-2)
        new = valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _bind(lib: ctypes.CDLL):
    fn = lib.greedy_nms_mask_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(boxes: torch.Tensor, scores: torch.Tensor):
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2]:
        raise ValueError(f"scores must be (B, K) = {tuple(boxes.shape[:2])}, "
                         f"got {tuple(scores.shape)}")
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
    global launches
    _check(boxes, scores)
    b, k = scores.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    fn = _bind(_build.load("greedy_nms"))
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = fn(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), b, k,
             float(iou_thres), boxes.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed: cudaError {err}")
    launches += 1
    return keep


def greedy_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """Exact greedy keep-mask: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if boxes.device.type == "cuda":
        return greedy_nms_mask_cuda(boxes, scores, iou_thres)
    if boxes.device.type == "cpu":
        return greedy_nms_mask_plain(boxes, scores, iou_thres)
    raise ValueError(f"no greedy_nms_mask for device {boxes.device}")
