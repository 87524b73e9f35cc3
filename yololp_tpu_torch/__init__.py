"""yololp-tpu-torch: the PyTorch/CUDA port of yololp_tpu for NVIDIA Hopper.

Deploy-mode license-plate inference of the yololps/yololpn configs: uint8
NHWC batch -> /255 -> fused RepVGG forward (EfficientRep + RepBiFPANNeck + LP
Detect) -> 290-column decode -> NMS whose greedy keep-mask runs in a
hand-written CUDA kernel (csrc/greedy_nms.cu). True-int8 inference
(quant/) runs every calibrated conv in a second one (csrc/int8_conv.cu).
The evaler (core/evaler.py, tools/eval.py) scores a checkpoint with the LP
metric; losses/ and assigners/ hold the training loss with ATSS and TAL;
solver/, core/train_step.py, core/engine.py and tools/train.py train
(Nesterov SGD, EMA, gradient accumulation, QAT's straight-through
fake-quant, the device-resident dataset cache) and write checkpoints in the
JAX package's msgpack format. export/ writes the end-to-end program with
torch.export (the kernels are custom ops, ops/library.py) and an
AOTInductor package, which deploy/aoti_cpp/'s C++ runner loads.

The package imports torch, numpy and the standard library only; cv2, yaml
and PIL are imported inside the functions that need them, and the
checkpoint codec is the package's own (no msgpack). Entry points take
an explicit `device`, default to "cuda" and raise when no GPU is present
unless the caller asks for "cpu".
"""

__version__ = "0.1.0"
