"""Ops of the port. Importing the package registers the kernels' custom ops
(`library.py`), which the wrappers in cuda_nms, cuda_conv, cuda_matmul and
cuda_bias_act call."""

from yololp_tpu_torch.ops import library  # noqa: F401
