"""The NMS gate in one pass: the CUDA kernel csrc/nms_gate.cu and its plain
PyTorch version.

`nms_gate(pred, conf_thres, compat_ad4_bug)` calls the custom op
`yololp_torch::nms_gate` (ops/library.py), which runs the kernel on a CUDA
tensor and the plain version on a CPU tensor; on a CUDA tensor it launches
the kernel or raises. From a (B, A, 290) fp32 contiguous decode it returns

    box    (B, A, 4)   xyxy of columns 0:4
    score  (B, A)      the mean of the 8 task maxima, 0 where the row fails the gate
    rest   (B, A, 24)  columns 5:13 (corners), the 8 task maxima, the 8 argmax ids as float
    passed (B, A)      bool: the row's gate (the mean, or with `compat_ad4_bug`
                       the reference's sum of ad4 twice and no ad5) >= conf_thres

`_build.launches("nms_gate")` counts the kernel's launches.

The kernel replaces no Pallas kernel: XLA fused the gate into one pass on
the TPU, while PyTorch ran it as some 30 kernels, each re-reading the
decode or a large part of it. It is bound by bytes, one read of the decode
(the design is in the source). Its arithmetic is the plain version's bit
for bit (the source says how); the plain version is the sequence
ops/nms.py:select_candidates ran before the op, and runs any dtype.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from yololp_tpu_torch.ops import _build
from yololp_tpu_torch.ops.geometry import xywh2xyxy

COLS = 290  # box 4, obj 1, corners 8, scores 31 + 24 + 6 x 37
NPRO, NALP, NADS = 31, 24, 37
REST_COLS = 24

_LAUNCH = _build.Kernel("nms_gate", "nms_gate_launch",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def _check(pred: torch.Tensor, *_):
    """pred's shape, dtype and layout (the op's other arguments take any value)."""
    if pred.dim() != 3 or pred.shape[-1] != COLS:
        raise ValueError(f"pred must be a (B, A, {COLS}) decode, got {tuple(pred.shape)}")
    if pred.dtype != torch.float32:
        raise TypeError(f"pred must be float32, got {pred.dtype}")
    if not pred.is_contiguous():
        raise ValueError(f"pred must be contiguous, got strides {pred.stride()}")


def _split_scores(cls: torch.Tensor) -> List[torch.Tensor]:
    """(..., 277) -> list of 8 per-task score tensors."""
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


def nms_gate_plain(pred: torch.Tensor, conf_thres: float, compat_ad4_bug: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(box, score, rest, passed) of a (B, A, 290) decode of any float dtype,
    in plain PyTorch: the kernel's arithmetic."""
    box = xywh2xyxy(pred[..., :4])
    cls = pred[..., 13:] * pred[..., 4:5]  # conf = obj_conf * cls_conf
    task_scores = _split_scores(cls)
    confs = torch.stack([t.amax(dim=-1) for t in task_scores], -1)    # (B, A, 8)
    preds = torch.stack([t.argmax(dim=-1) for t in task_scores], -1)  # first max
    score = _sum_in_order(confs, range(8)) / 8.0  # NMS ranking score
    if compat_ad4_bug:
        # the reference sums ad4 twice and omits ad5
        mask_conf = _sum_in_order(confs, (0, 1, 2, 3, 4, 5, 6, 6)) / 8.0
    else:
        mask_conf = score
    passed = mask_conf >= conf_thres
    gated = torch.where(passed, score, torch.zeros_like(score))
    rest = torch.cat([pred[..., 5:13], confs, preds.float()], -1)
    return box, gated, rest, passed


def empty_outputs(pred: torch.Tensor, *_):
    """The op's four outputs, uninitialized, on pred's device."""
    b, a = pred.shape[:2]
    return (pred.new_empty((b, a, 4)), pred.new_empty((b, a)), pred.new_empty((b, a, REST_COLS)),
            pred.new_empty((b, a), dtype=torch.bool))


def nms_gate_cuda(pred: torch.Tensor, conf_thres: float, compat_ad4_bug: bool):
    """Launch csrc/nms_gate.cu on a CUDA tensor; raise on any refusal."""
    _check(pred)
    if pred.device.type != "cuda":
        raise ValueError(f"the kernel takes cuda tensors, got {pred.device}")
    box, score, rest, passed = out = empty_outputs(pred)
    n_rows = pred.shape[0] * pred.shape[1]
    if n_rows == 0:
        return out
    _LAUNCH.launch(pred.device, pred.data_ptr(), n_rows, float(conf_thres),
                   int(bool(compat_ad4_bug)), box.data_ptr(), score.data_ptr(), rest.data_ptr(),
                   passed.data_ptr())
    return out


def nms_gate(pred: torch.Tensor, conf_thres: float, compat_ad4_bug: bool = False):
    """(box, score, rest, passed) through the op `yololp_torch::nms_gate`:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return torch.ops.yololp_torch.nms_gate(pred, float(conf_thres), bool(compat_ad4_bug))


OPS = (_build.Op("nms_gate(Tensor pred, float conf_thres, bool compat_ad4_bug) -> "
                 "(Tensor box, Tensor score, Tensor rest, Tensor passed)", "nms_gate", _check,
                 nms_gate_plain, nms_gate_cuda, empty_outputs, decompose=True),)
