"""The kernels as custom ops of one namespace, `yololp_torch`.

`torch.export` and AOTInductor cannot trace a ctypes call on `data_ptr()`,
and the plain NMS loops on data, so each kernel is registered as an op that
the tracer sees as one opaque node:

    yololp_torch::greedy_nms_mask   ops/cuda_nms.py   csrc/greedy_nms.cu
    yololp_torch::int8_conv         ops/cuda_conv.py  csrc/int8_conv.cu
    yololp_torch::matmul            ops/cuda_matmul.py csrc/mxu_matmul.cu
    yololp_torch::matmul_nt         ops/cuda_matmul.py csrc/mxu_matmul.cu
    yololp_torch::bias_act          ops/cuda_bias_act.py csrc/bias_act.cu
    yololp_torch::nms_gate          ops/cuda_nms_gate.py csrc/nms_gate.cu

Each op has three implementations, chosen by the dispatcher from the
device of its tensors: CUDA is the kernel's launcher (`*_cuda`, which checks
its inputs and raises on any refusal), CPU is the kernel's plain version (the
CPU's kernel, not a fallback), and a fake one gives the output's shape, dtype
and strides without reading data. The wrappers the call sites use
(`cuda_nms.greedy_nms_mask`, `cuda_conv.int8_conv`, `cuda_matmul.matmul`,
`cuda_matmul.matmul_nt`, `cuda_bias_act.bias_act`, `cuda_nms_gate.nms_gate`)
call the ops, so eager runs and exported programs reach each kernel through
one entry point.

`int8_conv` takes its output dtype as the kernel's mode number (`out_mode`:
0 int8, 1 float32, 2 bfloat16, 3 int32; `cuda_conv.out_mode`), not as a
ScalarType: torch 2.11's AOTInductor proxy executor hands a custom op's
ScalarType argument over in the export serializer's numbering, not c10's
(int8 arrives as int16, bfloat16 as a quantized type).

Every op is tagged `needs_exact_strides`: the launchers read their operands
through the strides an eager call passes (`matmul_nt` takes a conv tap's
weights as a strided view, rows 9C apart, without a copy) and refuse
layouts the kernels do not take, so a compiled graph must hand them the same
layouts as eager.

A process without Python (deploy/aoti_cpp/) registers the same schemas from
C++ in `ops.cpp`; `SCHEMAS` is the text both hold.
"""

from __future__ import annotations

import torch

from yololp_tpu_torch.ops import cuda_bias_act, cuda_conv, cuda_matmul, cuda_nms, cuda_nms_gate

NAMESPACE = "yololp_torch"
SCHEMAS = {
    "greedy_nms_mask": "greedy_nms_mask(Tensor boxes, Tensor scores, float iou_thres) -> Tensor",
    "int8_conv": ("int8_conv(Tensor x_q, Tensor w_q, Tensor a, Tensor b, int stride, bool relu, "
                  "int out_mode) -> Tensor"),
    "matmul": "matmul(Tensor a, Tensor b) -> Tensor",
    "matmul_nt": "matmul_nt(Tensor a, Tensor b_t) -> Tensor",
    "bias_act": "bias_act(Tensor y, Tensor b, int act) -> Tensor",
    "nms_gate": ("nms_gate(Tensor pred, float conf_thres, bool compat_ad4_bug) -> "
                 "(Tensor box, Tensor score, Tensor rest, Tensor passed)"),
}


def _nms_cpu(boxes, scores, iou_thres):
    return cuda_nms.greedy_nms_mask_plain(boxes, scores, iou_thres)


def _nms_fake(boxes, scores, iou_thres):
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes must be (B, K, 4) and scores (B, K), got {tuple(boxes.shape)} "
                         f"and {tuple(scores.shape)}")
    return scores.new_empty(scores.shape, dtype=torch.bool)


def _conv_cpu(x_q, w_q, a, b, stride, relu, out_mode):
    out_dtype = cuda_conv.mode_dtype(out_mode)
    cuda_conv._check(x_q, w_q, a, b, stride, out_dtype)
    return cuda_conv.int8_conv_plain(x_q, w_q, a, b, stride, relu, out_dtype)


def _conv_cuda(x_q, w_q, a, b, stride, relu, out_mode):
    return cuda_conv.int8_conv_cuda(x_q, w_q, a, b, stride, relu, cuda_conv.mode_dtype(out_mode))


def _conv_fake(x_q, w_q, a, b, stride, relu, out_mode):
    out_dtype = cuda_conv.mode_dtype(out_mode)
    cuda_conv._check(x_q, w_q, a, b, stride, out_dtype)
    n, h, w, _ = x_q.shape
    o, kh = w_q.shape[:2]
    return x_q.new_empty((n, cuda_conv.out_size(h, kh, stride), cuda_conv.out_size(w, kh, stride),
                          o), dtype=out_dtype)


def _mm_cpu(a, b):
    cuda_matmul._check(a, b)
    return cuda_matmul.matmul_plain(a, b)


def _mm_fake(a, b):
    cuda_matmul._check(a, b)
    return a.new_empty((a.shape[0], b.shape[1]), dtype=cuda_matmul._MODES[a.dtype][1])


def _mm_nt_cpu(a, b_t):
    cuda_matmul._check_nt(a, b_t)
    return cuda_matmul.matmul_nt_plain(a, b_t)


def _mm_nt_fake(a, b_t):
    cuda_matmul._check_nt(a, b_t)
    return a.new_empty((a.shape[0], b_t.shape[0]), dtype=cuda_matmul._MODES[a.dtype][1])


def _bias_act_cpu(y, b, act):
    cuda_bias_act._check(y, b, act)
    return cuda_bias_act.bias_act_plain(y, b, act)


def _bias_act_fake(y, b, act):
    cuda_bias_act._check(y, b, act)
    return torch.empty_like(y)


def _nms_gate_cpu(pred, conf_thres, compat_ad4_bug):
    cuda_nms_gate._check(pred)
    return cuda_nms_gate.nms_gate_plain(pred, conf_thres, compat_ad4_bug)


def _nms_gate_fake(pred, conf_thres, compat_ad4_bug):
    cuda_nms_gate._check(pred)
    return cuda_nms_gate.empty_outputs(pred)


_IMPLS = {
    "greedy_nms_mask": (_nms_cpu, cuda_nms.greedy_nms_mask_cuda, _nms_fake),
    "int8_conv": (_conv_cpu, _conv_cuda, _conv_fake),
    "matmul": (_mm_cpu, cuda_matmul.matmul_cuda, _mm_fake),
    "matmul_nt": (_mm_nt_cpu, cuda_matmul.matmul_nt_cuda, _mm_nt_fake),
    "bias_act": (_bias_act_cpu, cuda_bias_act.bias_act_cuda, _bias_act_fake),
    "nms_gate": (_nms_gate_cpu, cuda_nms_gate.nms_gate_cuda, _nms_gate_fake),
}

# the registrations live as long as this module (one per process: a second
# copy of the package in one process raises here)
_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, (_cpu, _cuda, _fake) in _IMPLS.items():
    _LIB.define(SCHEMAS[_name], tags=(torch.Tag.needs_exact_strides,))
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)
