"""Ops of the port. Importing the package registers the kernels' custom ops
(`library.py`, from the `OPS` records of cuda_nms, cuda_conv, cuda_matmul,
cuda_bias_act, cuda_nms_gate and cuda_quantize), which those modules'
wrappers call."""

from yololp_tpu_torch.ops import library  # noqa: F401
