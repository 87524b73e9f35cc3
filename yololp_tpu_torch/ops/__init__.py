"""Ops of the port. Importing the package registers the kernels' custom ops
(`library.py`), which the wrappers in cuda_nms, cuda_conv and cuda_matmul
call."""

from yololp_tpu_torch.ops import library  # noqa: F401
