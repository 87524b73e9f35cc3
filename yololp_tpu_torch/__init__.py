"""yololp-tpu-torch: the PyTorch/CUDA port of yololp_tpu for NVIDIA Hopper.

Deploy-mode license-plate inference of the yololps/yololpn configs: uint8
NHWC batch -> /255 -> fused RepVGG forward (EfficientRep + RepBiFPANNeck + LP
Detect) -> 290-column decode -> NMS whose greedy keep-mask runs in a
hand-written CUDA kernel (csrc/greedy_nms.cu).

The package imports torch, numpy and the standard library only; cv2 and
msgpack are imported inside the functions that need them. Entry points take
an explicit `device`, default to "cuda" and raise when no GPU is present
unless the caller asks for "cpu".
"""

__version__ = "0.1.0"
