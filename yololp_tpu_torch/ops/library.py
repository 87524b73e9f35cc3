"""The kernels as custom ops of one namespace, `yololp_torch`.

Adding a kernel takes three steps, and these places are all it touches.
(1) `csrc/X.cu`, which ops/_build.py builds at first use. (2)
`ops/cuda_X.py`: the plain version, the launcher (a `_build.Kernel` that
declares the C entry point's types, called through `Kernel.launch`), and
`OPS`, one `_build.Op` record an op (schema, input check, plain version,
launcher, fake, and whether export.inductor_program decomposes it); the
module joins `_MODULES` below, which registers its ops. (3) An entry of
`OPS` in tests/kernel_cases.py under each op's name (its cases, refusals
and empty input, which the card test of every op runs:
tests/test_torch_cuda.py fails to collect without it), and each op's
schema in deploy/aoti_cpp/ops.cpp, with a C++ launcher there only if the
C++ runner must launch it. The CPU tests find the rest from these: the
entry points from `csrc/`, the schemas from the records.

`torch.export` and AOTInductor cannot trace a ctypes call on `data_ptr()`,
and the plain NMS loops on data, so each kernel is registered as an op that
the tracer sees as one opaque node:

    yololp_torch::greedy_nms_mask   ops/cuda_nms.py   csrc/greedy_nms.cu
    yololp_torch::int8_conv         ops/cuda_conv.py  csrc/int8_conv.cu
    yololp_torch::matmul            ops/cuda_matmul.py csrc/mxu_matmul.cu
    yololp_torch::matmul_nt         ops/cuda_matmul.py csrc/mxu_matmul.cu
    yololp_torch::bias_act          ops/cuda_bias_act.py csrc/bias_act.cu
    yololp_torch::nms_gate          ops/cuda_nms_gate.py csrc/nms_gate.cu
    yololp_torch::quantize_codes    ops/cuda_quantize.py csrc/quantize.cu

Each op has three implementations, chosen by the dispatcher from the
device of its tensors: CUDA is the kernel's launcher (`*_cuda`, which checks
its inputs and raises on any refusal), CPU is the record's check and then
the kernel's plain version (the CPU's kernel, not a fallback), and a fake
one, the record's check and then its fake, gives the output's shape, dtype
and strides without reading data. The wrappers the call sites use
(`cuda_nms.greedy_nms_mask`, `cuda_conv.int8_conv`, `cuda_matmul.matmul`,
`cuda_matmul.matmul_nt`, `cuda_bias_act.bias_act`, `cuda_nms_gate.nms_gate`,
`cuda_conv.quantize_codes`) call the ops, so eager runs and exported
programs reach each kernel through one entry point.

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
C++ in `ops.cpp`; `SCHEMAS`, in ops.cpp's order, is the text both hold.
"""

from __future__ import annotations

import torch

from yololp_tpu_torch.ops import (cuda_bias_act, cuda_conv, cuda_matmul, cuda_nms, cuda_nms_gate,
                                  cuda_quantize)

NAMESPACE = "yololp_torch"
_MODULES = (cuda_nms, cuda_conv, cuda_matmul, cuda_bias_act, cuda_nms_gate, cuda_quantize)
RECORDS = tuple(op for m in _MODULES for op in m.OPS)
SCHEMAS = {op.name: op.schema for op in RECORDS}


def _checked(check, impl):
    def run(*args):
        check(*args)
        return impl(*args)
    return run


def decompositions() -> dict:
    """{op overload: its plain version} of the ops export.inductor_program
    writes out for Inductor."""
    ns = getattr(torch.ops, NAMESPACE)
    return {getattr(ns, op.name).default: op.plain for op in RECORDS if op.decompose}


# the registrations live as long as this module (one per process: a second
# copy of the package in one process raises here)
_LIB = torch.library.Library(NAMESPACE, "DEF")
for _op in RECORDS:
    _LIB.define(_op.schema, tags=(torch.Tag.needs_exact_strides,))
    _LIB.impl(_op.name, _checked(_op.check, _op.plain), "CPU")
    _LIB.impl(_op.name, _op.cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_op.name}", _checked(_op.check, _op.fake),
                                lib=_LIB)
