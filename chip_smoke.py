#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (yololp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one NVIDIA card and the CUDA
toolkit. The card check of every kernel against its plain version is not
here but in the card test, over the cases of tests/kernel_cases.py:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

This script drives the paths that run the kernels, times them, and takes
its kernels' operands from tests/kernel_cases.py. Its phases keep their
numbers; 3, 6 and 9 (the greedy-NMS, int8 conv and matmul kernels against
their plain versions) moved into the card test, as did the kernel-against-
plain halves of 26 and 27. Phases, each of which raises on failure:

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every kernel of csrc/ with nvcc (one process per source, in parallel);
  4. the main path: yololps at full width, every parameter drawn from a seeded
     generator, fused to the deploy graph, `Inferer.detect_batch` on 32 BGR
     frames at 640x640 and 360x640 (pad only, no cv2), with the launch counts
     of the greedy-NMS kernel and of the NMS gate kernel (once a batch) read
     around that call; then the card's (32, 8400, 290) decode
     through the plain NMS on the CPU (exact equality), and one image in fp32
     with TF32 off on the card against the port on the CPU;
  5. times, by CUDA events: end-to-end img/s at batch 32 in bf16 and fp32, a
     torch.profiler table of one bf16 batch by kernel (the NMS kernel's
     device time read from it by name), and the NMS kernel on the main
     path's own candidates at B = 32 and B = 1, timed alone and by the
     profiler, beside its plain version, its bound and the kept count; then
     the NMS stage of one bf16 batch by kernel (gate reductions, sort,
     gathers, the kernel, compaction);
  7. the int8 main path: calibrate (max) on two batches of the seeded frames
     on the card, write and reload the amax json, install
     `make_int8_infer_fn(conv_impl="pallas")` as the inferer's `_run` (as the
     CLI's --int8 does) and run `detect_batch` on the 32 frames, reading the
     int8_conv, greedy_nms and quantize launch counts around that call (one
     quantize launch a float -> code quantize); the kernel against plain on a
     chain link's own entry codes from the run; the card's int8 decode
     through the plain NMS on the CPU (exact); one image with
     conv_impl="conv" in fp32 (TF32 off) on the card against the CPU port:
     every int8 module of the port on the CPU, fed the card's own input,
     gives the card's output bit for bit, and the two decodes differ by no
     more than int8's own quantization noise on that image. The /255 input
     and every input quantize are computed alike on both (a multiply by an
     fp32 reciprocal from the host, ops/division.py); what is left is a
     float conv, the stem or an upsample, that sums in another order on the
     card, which flips a few codes; with random weights each flip spreads,
     so the decodes are not held to a fixed bound;
  8. int8 times: img/s at batch 32 beside phase 5's bf16, a profiler table
     of one int8 batch, and every distinct int8 conv launch of the main path
     timed alone (kernel, plain version, bound, and a cuDNN bf16 conv of the
     same shape as a reference point), with each launch's tile, stage count
     and shared memory and the kernel's ptxas registers; then one batch
     while spans record (its `int8.quantize` spans, the `int8.quantize_fused`
     count and the quantize launches all equal phase 7's count), and every
     quantize of phase 7's batch at b128 (its input tiled 4 times, its
     layout and scale): the op bit for bit against its plain version with
     the input's strides, the kernel's time alone beside its bound (one read
     of x, one write of the codes) and the plain version's five passes, and
     the batch's launches on the device;
  10. the dots int8 main path: with phase 7's calibration,
     `make_int8_infer_fn(conv_impl="dots")` and then "conv" as the inferer's
     `_run`, `detect_batch` on the 32 frames, the launch counts of both
     kernels read around each call and held to what the model's int8
     geometries imply (a 3x3/s1 conv is 9 matmuls, a 1x1/s1 conv one, every
     other conv one int8_conv launch); the two plans' detections equal bit
     for bit; the dots route on a chain link's own entry codes equal to the
     exact accumulator; img/s of both plans and a profiler table of one
     dots batch;
  11. times: every distinct matmul launch of one dots batch timed alone (on
     the strided tap views the dots plan passes), and the kernel at the
     probe's shapes (ms, rate, bound, plain version, and torch.matmul /
     torch._int_mm as the library's time), with tiles, stages, shared memory
     and ptxas registers; then each ported measurement tool's main() once at
     small step counts and batch 32 (bench_nms, and the train and int8
     probes profile_train, probe_train_mfu and probe_int8_e2e, too);
  12. the evaler on the card: 70 frames at 640x640 held in memory with 1-4
     plate boxes each (labels padded to 32), fed as loader batches of 32 (the
     tail of 6 padded by `Evaler.predict`), through `Evaler.predict` and
     `Evaler.eval` with the bf16 deploy model and then the int8 pallas plan
     on phase 7's calibration; each run's launch counts are set to 0 just
     before and read just after; the detections and the metric list equal
     those of the plain CPU NMS on the card's own decode of the same
     frames; prints the metric list and `eval_speed()`;
  13. the train graph of yololps (every parameter and BN statistic drawn
     from the seed): forward, ATSS assignment, loss (giou, no DFL) and
     backward. Parity at batch 2 in fp32 with TF32 off: the fg masks of the
     card and the CPU equal (else each differing anchor's IoU is printed
     beside its threshold), the 7 loss items and the total within rtol
     1e-3, the gradients w.r.t. reg and cor within 1e-2 of their largest
     magnitude; then ms per step by part, img/s and max_memory_allocated at
     batch 32 under autocast(bfloat16) with fp32 parameters (no optimizer
     step);
  14. the training path: `make_train_step` (forward, ATSS, loss, backward,
     Nesterov SGD, the EMA of the parameters and BN statistics) at 640. Parity
     in fp32 (TF32 off) at batch 2, card against the CPU port, 3 steps from
     step 0, each step run on both from the card's state before it: the loss
     items of each step within rtol 1e-3, the parameters, momentum and EMA
     as updates over the step, each tensor's within TRAIN_UPDATE_TOL of its
     largest update; from a state past warmup
     at batch 32 (accumulation 2) the optimizer applies on exactly the steps
     the host predicts; one QAT step (fake-quant with the straight-through
     gradient) on phase 7's amax, finite, its difference from the CPU
     printed, and one with the network input alone fake-quantized, its items
     within rtol 1e-3 of the CPU's. Times at batch 32 under autocast(bfloat16): the full step by
     part (forward, assign, loss, backward, SGD + EMA), img/s and peak
     memory, and one cached epoch of 4 steps over 128 frames staged on the
     card. Then `Trainer` for 2 epochs with --cache-device over a dataset
     held as the device cache's .npy memos (no image is decoded), eval every
     epoch on phase 12's in-memory frames (given through the Trainer's
     `_eval_cache`), the NMS kernel's launch count zeroed and read around
     each eval; the final checkpoint reloads through
     `load_inference_variables` equal to the trained EMA fused, and its
     detections on the card equal the plain CPU NMS's on the card's decode;
  15. the zoo at published width and depth (yolov6m, yolov6l, yolov6s6,
     yolov6l6, base/yolov6s_base, repopt/yolov6s_hs and repopt/yolov6s_opt,
     each fused, every parameter drawn from a seed): bf16 `Inferer._run` at
     640x640, batch 32, with the NMS kernel's launches read around it; fp32
     decode at batch 2 against the port on the CPU; detections equal the
     plain CPU NMS's on the card's decode;
  15b. yolov6m under --int8: calibrated on two batches, the pallas plan at
     batch 32 (int8_conv launches equal the calibrated convs the plan runs),
     module replay card against CPU bit for bit, the dots plan at batch 8
     (mxu_matmul launches counted, detections equal the conv plan's); the
     conv_silu yolov6l's plan emits no handoff;
  16. a yolov6m train step (ATSS, giou, DFL): fp32 at batch 2 against the
     CPU from one state, then ms per step by part and peak memory under
     autocast bf16;
  17. RepOpt: 2 hyper-search steps of yolov6s_hs, its scales saved and
     loaded, yolov6s_opt re-initialized from them with its gradient masks,
     3 masked steps at 640 x 32, one fp32 step at batch 2 against the CPU,
     and the Trainer's RepOpt path for an epoch of 2 steps;
  18. distillation: yololpn from a yololps teacher whose checkpoint the port
     writes, the KD terms card against CPU in fp32 and the step time; then
     tools.sensitivity's analysis of yololpn at 320 px on 32 frames labelled
     with that float model's own detections: the baseline mAP is above 0 and
     at least one conv's drop is not 0;
  19. sharded inference and eval (parallel/infer.py): the bf16 yololps batch
     of 32 split over a mesh of 2 cards, or of 2 replicas on cuda:0 when the
     machine has one card; greedy_nms launches read around the call (one a
     card a batch); det/valid/num equal to the plain CPU NMS on the sharded
     run's own decode; the decode within SHARD_* of the single-device one;
     then Evaler.predict and eval with mesh= on phase 12's 70 frames: one
     launch a card a batch, detections equal to the plain CPU NMS on the
     sharded decode, the metric equal to the single-device metric;
  20. data-parallel training in spawned ranks: NCCL with one rank a card
     when there are 2 cards, else 2 gloo ranks sharing cuda:0 (NCCL refuses
     two ranks on one card; printed as a plumbing check, not a scaling
     number). One fp32 step (TF32 off) of yololps at 640, global batch 4,
     ATSS, rank 1 without ground truth, against one process on the global
     batch on the card from the same state: fg masks equal, loss within
     rtol 1e-3, updates within phase 14's bounds, BN running statistics
     within rtol 1e-4; a bf16 step at global batch 32 timed by CUDA events;
     the Trainer with --cache-device for an epoch of 2 steps over phase 12's
     frames (held as memos), eval on rank 0 only (greedy_nms launches there
     and nowhere else), one checkpoint that reloads as rank 0's EMA fused
     bit for bit, the EMA equal on every rank; with one card, the Trainer
     once more under NCCL at world size 1;
  21. export (yololp_tpu_torch.export, deploy/aoti_cpp): the bf16 end2end
     program of phase 4's inferer and the int8 one on phase 7's
     calibration (the conv plan), each returning its decode beside
     det/valid/num, taken by torch.export at batch 32 and 640. Saved and
     loaded as a .pt2: greedy_nms once, and int8_conv (68), the deploy
     convs' bias_act and the int8 quantize as often as eager, a batch, one
     node a launch (no bias_act or quantize inside the AOTInductor package
     below: export.inductor_program hands Inductor the epilogues' and the
     quantizes' plain arithmetic to fuse); det/valid/num equal to the plain
     CPU NMS on its own decode
     and to eager's bit for bit. Compiled into an AOTInductor package
     (compile seconds printed) and run through aoti_load_package: the same
     launch counts, read from inside the package; det/valid/num equal to
     the plain CPU NMS on the package's own decode; the decode's boxes and
     corners equal to eager's (bf16) or the eager conv plan's (int8) bit for
     bit and its scores within EXPORT_SCORE_ATOL, valid and num equal; the
     kernels by name in a profiler table of one
     batch. The C++ runner (built beside phases 4-20) runs --bench 20 on
     both packages: its first LCG batch's num equals the Python package's
     on that batch, rebuilt in numpy, and it reports one greedy_nms, 68
     int8_conv and no bias_act launch a batch. img/s of eager, the .pt2, the package and
     the runner's sync and pipelined loops by CUDA events (the runner by
     its host clock); the host cost of an op dispatch against the launcher
     called directly (and a torch.library.custom_op twin), times the
     launches a batch;
  22. the diagnostics (tools.diag_strict, tools.diag_province and
     utils/metrics): phase 12's 70 frames at 640 labelled with the bf16
     model's own detections (every second label's characters moved, every
     third label's box narrowed to 0.6 of its width), through
     Evaler.predict with the NMS kernel's launches read around it (one a
     batch: 3), detections equal to the plain CPU NMS on the card's decode;
     diag_strict's funnel in order (gt >= matched50 >= matched70 >=
     both_ok), slot accuracies in [0, 1], character_confusions over the
     targets matched at IoU 0.7 counting decompose's wrong slots, and
     diag_province's width buckets summing to gt; then diag_scan_walls at its
     defaults (every wall finite and positive); then the encoded-image path
     on phase 4's frames written as BMPs: where OpenCV or cv2 exists,
     detect_batch_encoded equal to detect_batch and the host decode's ms a
     batch, else the asserted refusal (native_available() False, and
     detect_batch_encoded and Evaler.init_data(native=True) raise the
     RuntimeError naming both);
  23. the spatial mesh (parallel/spatial.py): yololps at full width and
     depth, the seeded fused deploy model, height-sharded over (data,
     spatial) meshes (1, 2), (1, 4) and (2, 2) (one card: every entry
     cuda:0; several: the entries wrap round the cards). In fp32 at batch 8:
     the gathered decode against the unsharded `_run` decode (phase 4's fp32
     tolerance), the detections equal to the plain CPU NMS on that decode,
     and n_data greedy_nms launches a batch; in bf16, ms a batch of 32
     beside the unsharded `_run`; then one 2560x2560 frame on (1, 4) against
     the unsharded forward of the same frame (fp32 parity, bf16 times, peak
     memory); halo rows and bytes a forward, and the host's enqueue time of
     a batch beside the unsharded one's;
  24. the JAX NMS's variants (ops/nms.py): phase 4's bf16 inferer built
     again with nms_selector="approx", phase 7's int8 pallas plan and phase
     19's mesh, each run with the "approx" selector (the same exact top-K as
     "topk" off the TPU) and held bit for bit to its "topk" run, the launch
     counts set to 0 just before and read just after (one greedy_nms launch
     a batch, one a mesh entry sharded); nms_iters 1, 2 and 16 (a fixed
     number of update steps in plain PyTorch ops, no kernel launch) on
     phase 4's decode, keep-mask and detections equal to the same call on
     the CPU; on a 512-deep band chain nms_iters=16 equal to the
     CPU and unequal to the exact mask; then bench_nms's grid (nms_iters
     0 and 16, and the candidate step alone; off the TPU "approx" runs the
     same program as "topk", which the tool times once for both keys) at
     B = 32, K = 512;
  25. the port's bench (yololp_tpu_torch/bench.py), its legs called in-process
     at full size on the seeded yololps that the bench's main() builds:
     bench_inference at 640 b128 (20 chained steps, then the per-batch-synced
     number), bench_int8 at b128 (calibrated, the conv plan built once with
     stage handoffs), bench_train_step at b32 (10 steps) and b128 (6), and
     bench_native_runner on phase 21's b32 packages (no second AOTInductor
     compile). Every leg returns a positive finite number; the launch
     counts, set to 0 just before each leg and read just after, are one
     greedy_nms a chained step (and one a synced batch) and as many int8_conv
     a step as phase 21's eager conv plan. Then the legs' programs once
     more on one staged b128 batch: the e2e program's and the timed int8
     plan's detections equal the plain CPU NMS on their own decode; the int8
     plan run again with every int8 conv in the plain version gives its
     decode (boxes bit for bit, scores within EXPORT_SCORE_ATOL); and the e2e
     program on phase 4's weights at phase 4's gate (2K anchors of every
     image pass, so greedy_nms walks a full K = 256 in one launch) equals the
     plain CPU NMS on its decode. The bench's line of the numbers is printed;
  26. the deploy convs' epilogue kernel (csrc/bias_act.cu) at every
     distinct conv-output shape of the yololps and yolov6m deploy forwards
     at b128: each model's b128 forward with the kernel against the same
     forward on the parent's sequence (a no-op hook on each biased conv
     keeps it on cuDNN's bias add), decode bit for bit unless the kernel's
     SiLU rounds apart from PyTorch's on one of those shapes, and 71 / 108
     launches a forward (0 / 24 in the residual form); per model and form
     the kernel's time alone summed over a forward beside the bound (twice
     the conv outputs' bytes over 3.35 TB/s, three times in the residual
     form), the plain version's and the unfused sequence's, its device time
     in a profiled forward, and both forwards' times and profiles; then the
     residual form at every distinct residual shape of the CSP cells at
     their own batch and size (yolov6m b128 at 640 with ReLU, yolov6l6 b32
     at 1280 with SiLU), bit for bit against the plain form's kernel then
     PyTorch's alpha * x and add (kernel_cases.check_residual);
  27. the NMS gate kernel (csrc/nms_gate.cu) on the served yololps b128
     decode (8400 anchors): every output bit for bit against the plain
     version at thresholds 0.4 and the median score, compat_ad4_bug on and
     off; `non_max_suppression` with the op against the plain gate; an
     exported program holds one `nms_gate` node and launches it once, its
     AOTInductor program none; at the cells' shapes (128 x 8400, 32 x
     34000) the kernel's time alone (CUDA events, 100 launches) and in a
     device trace beside its bytes' bound, the plain version's, and the NMS
     stage with each.

It prints the kernels line and, last, {"ok": true, "device": {...}}. Without a
card it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from kernel_cases import (CHAINS, EPILOGUE_BATCH, MM_PROBE, RESIDUAL_IMG,  # noqa: E402
                          RESIDUAL_SHAPES, chain_boxes, check_quantize, check_residual,
                          epilogue_operand, eval_on_card, gate_decode, gate_equal,
                          labelled_frames, loader_batches, matmul_operands, own_gts,
                          randomize_parameters, unfused_epilogue)

BATCH = 32
IMG = 640
SEED = 0
DEVICE = "cuda:0"
TOPK = 512  # the NMS's pre_nms_topk: the kernel's K on the main path
# fp32 card-vs-CPU decode: cuDNN and the CPU library sum conv products in
# other orders (and may pick Winograd), compounded over ~70 convs.
FP32_RTOL, FP32_ATOL_PX, FP32_ATOL_SCORE = 2e-3, 0.1, 2e-3
EVAL_FRAMES = 70  # phase 12: two full batches of 32 and a tail of 6
TRAIN_PARITY_BATCH, TRAIN_STEPS = 2, 5
# phase 13, card vs CPU in fp32: the loss items and total within this
# relative difference, the gradients w.r.t. reg and cor within this fraction
# of their largest magnitude (cuDNN and the CPU sum conv products in other
# orders, and BN in training mode normalizes by the batch's own statistics)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-3, 1e-2
# phase 14, card vs CPU in fp32, each optimizer step from one state: each
# tensor's update within this fraction of its largest update, plus
# TRAIN_UPDATE_FLOOR of the largest update of any tensor. fp32's error in a
# backward sum is relative to its terms: a tensor whose gradient is tiny
# against the rest, or zero in exact arithmetic, carries noise of the whole
# backward's scale (tests/test_torch_train_step.py), and cuDNN's fp32 weight
# gradients sum in other orders than the CPU's (measured on the card: up to
# 1.35e-3 of the largest momentum update, in a neck conv's momentum)
TRAIN_UPDATE_TOL, TRAIN_UPDATE_FLOOR = 5e-2, 1e-2
TRAINER_FRAMES, TRAINER_EPOCHS = 128, 2
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor fp32 op/s and
# dense int8 tensor-core op/s
HBM_BYTES_S, FP32_OPS_S, INT8_OPS_S = 3.35e12, 67e12, 1979e12
BF16_OPS_S = 989e12  # dense bf16 tensor-core op/s

# operations per (i, j) pair of the IoU bitmask: 2 max, 2 min, 2 sub, 2 clip,
# 1 mul, 2 add, 1 sub, 1 div, 1 compare; plus 5 per box for its area
IOU_PAIR_OPS, AREA_OPS = 15, 5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_build_runner():
    """(the C++ runner's binary, its build's seconds)."""
    from yololp_tpu_torch.deploy.aoti_cpp import build_runner

    t0 = time.perf_counter()
    return build_runner(), time.perf_counter() - t0


def cuda_ms(fn, reps: int, windows: int = 5) -> list:
    """Milliseconds per call of `fn` by CUDA events: `windows` windows of
    `reps` back-to-back calls each, one event pair around each window."""
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def frames(rng):
    """BGR frames: 640x640, and 360x640 which the letterbox only pads (no cv2)."""
    return [rng.integers(0, 256, (IMG if i % 4 else IMG * 9 // 16, IMG, 3), np.uint8)
            for i in range(BATCH)]


def profile_batch(fn, card: str, label: str = "bf16", calls: int = 2, top_n: int = 12,
                  batch: int = BATCH) -> dict:
    """Device time by kernel over `calls` warm calls of `fn`, by torch.profiler,
    beside the window's CUDA-event time: where an end-to-end batch goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end) / calls
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = getattr(e, "self_device_time_total", 0) / 1e3 / calls
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:top_n]
    print(f"[{card}] profile, one {label} batch of {batch}: window {window_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}%), "
          f"{len(kernels)} kernel names")
    for name, ms in top:
        print(f"  {ms:8.3f} ms {100 * ms / window_ms:5.1f}%  {name[:110]}")
    return dict(window_ms=window_ms, busy_ms=busy_ms, top=top, by_name=kernels)


def nms_bound(b, k):
    """(bound ms, bound_by) of the keep-mask of B images of K boxes: 20 bytes
    read and 1 written a box; the K(K-1)/2 IoU tests and K areas at the
    fp32 rate."""
    nbytes = b * k * (16 + 4 + 1)
    ops = b * (k * (k - 1) // 2 * IOU_PAIR_OPS + k * AREA_OPS)
    t_b, t_o = nbytes / HBM_BYTES_S, ops / FP32_OPS_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations")


# the NMS stage's kernels by part, matched on the kernel's name in order
# (a scatter/gather kernel instantiated with true scatters, false gathers)
NMS_PARTS = (("greedy_nms kernel", ("greedy_nms_kernel",)),
             ("sort", ("RadixSort", "radix", "sort")),
             ("gate reductions (amax, argmax)", ("reduce_kernel",)),
             ("compaction (cumsum, scatter)", ("scan", "internal_kernel<true")),
             ("gathers", ("internal_kernel<false", "gather", "index")),
             ("concatenations and copies", ("CatArray", "copy")))


def nms_part(name):
    for part, keys in NMS_PARTS:
        if any(k in name for k in keys):
            return part
    return "elementwise and other"


def phase_nms_times(results, card, cuda_nms, box_k, score_k, thr, pred, nms_kw):
    """5 (NMS). The kernel's device time in the profiled bf16 batch; the
    kernel on the main path's candidates at B = 32 and B = 1, timed alone
    (CUDA events, back to back) and by the profiler, beside its plain
    version, its bound and the kept count; the NMS stage of one bf16 batch
    by kernel."""
    from yololp_tpu_torch.ops.nms import non_max_suppression
    from yololp_tpu_torch.utils.profiler import kernel_device_ms

    in_batch = sum(v for k, v in results["profile_bf16"]["by_name"].items() if "greedy_nms_kernel" in k)
    print(f"[{card}] greedy_nms_kernel in the profiled bf16 batch: {in_batch:.4f} ms device time")
    rows = {}
    for b in (score_k.shape[0], 1):
        bx, sc = box_k[:b], score_k[:b]
        keep = cuda_nms.greedy_nms_mask(bx, sc, thr)
        kept = keep.sum(1)
        for _ in range(5):
            cuda_nms.greedy_nms_mask(bx, sc, thr)
        # the launcher directly (its dispatch as an op: phase 21)
        ms = float(np.median(cuda_ms(lambda: cuda_nms.greedy_nms_mask_cuda(bx, sc, thr), 100)))
        dev_ms = kernel_device_ms(lambda: cuda_nms.greedy_nms_mask(bx, sc, thr), "greedy_nms_kernel", 20)
        plain_ms = float(np.median(cuda_ms(lambda: cuda_nms.greedy_nms_mask_plain(bx, sc, thr), 4)))
        bound_ms, bound_by = nms_bound(b, bx.shape[1])
        rows[b] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       kept=int(kept.sum()), kept_max=int(kept.max()))
        print(f"[{card}] greedy_nms B={b} K={bx.shape[1]}: kept {int(kept.sum())} (at most "
              f"{int(kept.max())} an image, the walk's steps), kernel {ms:.4f} ms timed alone (CUDA events, "
              f"median of 5 windows of 100), {dev_ms:.4f} ms device time (profiler, 20 calls), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}")

    stage = profile_batch(lambda: non_max_suppression(pred, **nms_kw), card,
                          label="NMS stage (bf16 decode)", top_n=30)
    parts = {}
    for name, ms in stage["by_name"].items():
        parts[nms_part(name)] = parts.get(nms_part(name), 0.0) + ms
    print(f"[{card}] NMS stage of one bf16 batch by part (device ms): " +
          ", ".join(f"{p} {ms:.4f}" for p, ms in sorted(parts.items(), key=lambda kv: -kv[1])))
    results["nms"] = dict(in_batch_device_ms=in_batch, by_batch=rows, stage=stage, stage_parts=parts)
    return results["nms"]


def check_int8(cuda_conv, x, w, a, b, stride, relu, dt, what):
    """Kernel against plain on card tensors: equal to the bit; |diff| max."""
    got = cuda_conv.int8_conv_cuda(x, w, a, b, stride, relu, dt)
    torch.cuda.synchronize()
    want = cuda_conv.int8_conv_plain(x, w, a, b, stride, relu, dt)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"int8_conv [{what}]: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = float((got.double() - want.double()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"int8_conv kernel != plain [{what}]: max |diff| {err}, "
                             f"{int((got != want).sum())} of {got.numel()} differ")
    return got, err


def kernel_report(name, plans):
    """Print each launch shape's tile, stage count and dynamic shared
    memory, and the ptxas registers, static shared memory and spills of
    every instance of csrc/<name>.cu; return both."""
    from yololp_tpu_torch.ops import _build

    for label, p in plans.items():
        print(f"  {name} {label}: tile {p['tile'][0]}x{p['tile'][1]}, {p['stages']} stages, "
              f"{p['smem_bytes']} B dynamic shared memory")
    usage = _build.ptxas_usage(name)
    for u in usage:
        print(f"  ptxas {u['entry']}: {u['registers']} registers, {u['smem_bytes']} B static "
              f"shared memory, {u['spill_bytes']} B spill stores")
    return dict(plans=plans, ptxas=usage)


class LaunchLog:
    """Forward pre-hooks on the int8 modules that record each int8 conv
    launch's geometry (N, H, W, C, O, K, stride, relu, out dtype)."""

    def __init__(self, int8_model, int8_mod):
        self.launches, self.chain_inputs, self.handles = [], {}, []
        for name, m in int8_model.named_modules():
            if isinstance(m, int8_mod.Int8Conv2d):
                self.handles.append(m.register_forward_pre_hook(self._conv))
            elif isinstance(m, int8_mod.Int8RepBlock):
                self.handles.append(m.register_forward_pre_hook(self._chain(name.replace(".", "/"))))

    def _conv(self, m, args):
        x = args[0]
        n, c, h, w = x.shape
        self.launches.append((n, h, w, c, m.w_q.shape[0], m.w_q.shape[1], m.stride, m.handoff,
                              m.out_dtype(x)))

    def _chain(self, path):
        def hook(m, args):
            x = args[0]
            self.chain_inputs[path] = x
            n, c, h, w = x.shape
            for w_q, _, _, dt in m.links_for(x)[1]:
                self.launches.append((n, h, w, c, w_q.shape[0], 3, 1, True, dt))
                c = w_q.shape[0]
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def int8_bound(n, h, w, c, o, k, stride, dt):
    """(bound ms, bound_by, ops, bytes) of one launch: each input byte read
    once, each output byte written once, 2 ops a MAC at the int8 peak."""
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    out_b = torch.empty((), dtype=dt).element_size()
    nbytes = n * h * w * c + o * k * k * c + 8 * o + n * ho * wo * o * out_b
    ops = 2 * n * ho * wo * o * k * k * c
    t_b, t_o = nbytes / HBM_BYTES_S, ops / INT8_OPS_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations"), ops, nbytes


def time_int8_launches(cuda_conv, counts, rng, dev, card):
    """Every distinct int8 conv launch of one main-path batch, timed alone by
    CUDA events: the kernel, its plain version, the bound, and a cuDNN bf16
    conv of the same shape (a reference point: no PyTorch call computes this
    int8 function on CUDA). Returns per-batch totals and the rows."""
    import torch.nn.functional as F

    rows, plans = [], {}
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, cudnn_bf16_ms=0.0, ops=0, bytes=0)
    for (n, h, w, c, o, k, stride, relu, dt), count in sorted(counts.items(), key=lambda kv: -kv[0][1]):
        x = torch.from_numpy(rng.integers(-128, 128, (n, h, w, c)).astype(np.int8)).to(dev)
        wq = torch.from_numpy(rng.integers(-128, 128, (o, k, k, c)).astype(np.int8)).to(dev)
        a = torch.full((o,), 1e-5, device=dev)
        b = torch.zeros(o, device=dev)
        for _ in range(3):
            cuda_conv.int8_conv_cuda(x, wq, a, b, stride, relu, dt)
        ms = float(np.median(cuda_ms(lambda: cuda_conv.int8_conv_cuda(x, wq, a, b, stride, relu, dt), 10)))
        plain_ms = float(np.median(cuda_ms(lambda: cuda_conv.int8_conv_plain(x, wq, a, b, stride, relu, dt), 1, 3)))
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # NCHW view, channels_last
        wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bb = b.to(torch.bfloat16)
        ref_ms = float(np.median(cuda_ms(lambda: F.conv2d(xb, wb, bb, stride, k // 2), 10)))
        bound_ms, bound_by, ops, nbytes = int8_bound(n, h, w, c, o, k, stride, dt)
        row = dict(shape=[n, h, w, c, o, k, stride], relu=bool(relu), out=str(dt)[6:], launches=count,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   cudnn_bf16_ms=ref_ms)
        rows.append(row)
        plans[f"O={o} {row['out']}"] = cuda_conv.plan(o, dt)
        for key in ("ms", "plain_ms", "bound_ms", "cudnn_bf16_ms"):
            tot[key] += count * row[key]
        tot["ops"] += count * ops
        tot["bytes"] += count * nbytes
        print(f"[{card}] int8_conv N{n} {h}x{w} C{c}->O{o} k{k} s{stride} {row['out']}: "
              f"x{count}/batch, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
              f"by {bound_by} ({100 * bound_ms / ms:.1f}% of it), cuDNN bf16 conv (reference) {ref_ms:.4f} ms")
    print(f"[{card}] int8_conv tiles:")
    tot["kernel"] = kernel_report("int8_conv", plans)
    return tot, rows


def recorded_quantize_counts(run, batch):
    """One batch of the int8 plan `run` while spans record: the `int8.quantize`
    spans, the `int8.quantize_fused` count (the kernel's launches, counted by
    its launcher) and the `quantize` launches."""
    from torch.profiler import ProfilerActivity, profile

    from yololp_tpu_torch.ops import _build
    from yololp_tpu_torch.utils import profiler as P

    P.reset_spans()
    before = _build.launches("quantize")
    with profile(activities=[ProfilerActivity.CPU]):
        run(batch)
        torch.cuda.synchronize()
    spans = P.span_totals().get("int8.quantize", {}).get("count", 0)
    fused = P.counters().get("int8.quantize_fused", 0)
    P.reset_spans()
    return dict(spans=spans, fused=fused, launches=_build.launches("quantize") - before)


def like_at_batch(x, batch):
    """x's values tiled along dim 0 to `batch`, with x's order of strides
    (channels_last stays channels_last)."""
    order = sorted(range(x.dim()), key=lambda d: x.stride(d), reverse=True)
    back = sorted(range(x.dim()), key=order.__getitem__)
    tiled = torch.cat([x] * (batch // x.shape[0]))
    return tiled.permute(order).contiguous().permute(back)


def time_quantize_launches(quantized, card):
    """Every float -> code quantize of one main-path batch, at b128: the
    input of each quantize of the run tiled 4 times along the batch, with its
    layout and the plan's own scale. The op bit for bit against its plain
    version (codes and strides: kernel_cases.check_quantize), the kernel's
    time alone by CUDA events (its launcher called directly, as phase 8
    times int8_conv), the plain version's five passes, the bytes' bound (x
    read once, the codes written once, at 3.35 TB/s), and the device time of
    the batch's launches by torch.profiler. Returns totals and the rows."""
    from yololp_tpu_torch.ops import cuda_conv, cuda_quantize

    rows, calls = [], []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, elements=0, max_abs_err=0.0)
    for x, inv in quantized:
        big = like_at_batch(x, EPILOGUE_BATCH)
        got = cuda_conv.quantize_codes(big, inv)
        check_quantize((big, inv), got, f"{tuple(big.shape)} {big.dtype} at the plan's scale")
        nbytes = big.numel() * (big.element_size() + 1)
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        fn = lambda big=big, inv=inv: cuda_quantize.quantize_codes_cuda(big, inv)  # noqa: E731
        fn()
        ms = float(np.median(cuda_ms(fn, 20)))
        plain_ms = float(np.median(cuda_ms(
            lambda: cuda_quantize.quantize_codes_plain(big, inv), 2, 3)))
        rows.append(dict(shape=list(big.shape), dtype=str(big.dtype)[6:],
                         channels_last=big.is_contiguous(memory_format=torch.channels_last),
                         inv_scale=inv, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         share=bound_ms / ms))
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                       ("bytes", nbytes), ("elements", big.numel())):
            tot[key] += v
        calls.append(fn)
        del got
    device = profiled_device_ms(lambda: [fn() for fn in calls], "quantize_kernel",
                                tot["bound_ms"], calls=3)
    tot["device_ms"] = device
    largest = max(rows, key=lambda r: r["bound_ms"])
    smallest = min(rows, key=lambda r: r["bound_ms"])
    for label, r in (("largest", largest), ("smallest", smallest)):
        print(f"[{card}] quantize {label} {r['shape']} {r['dtype']} "
              f"(channels_last {r['channels_last']}): kernel {r['ms']:.4f} ms alone, bound "
              f"{r['bound_ms']:.4f} ms ({100 * r['share']:.1f}% of it), plain {r['plain_ms']:.3f} ms")
    on_device = ("not measured (the profiler lost launches)" if device is None else
                 f"{device:.3f} ms ({100 * tot['bound_ms'] / device:.1f}% of the bound)")
    print(f"[{card}] quantize, all {len(rows)} of one batch at b{EPILOGUE_BATCH} "
          f"({tot['elements'] / 1e9:.3f} G elements, {tot['bytes'] / 1e9:.3f} GB), each bit for "
          f"bit with the plain version: kernel {tot['ms']:.3f} ms alone, device {on_device}, "
          f"bound {tot['bound_ms']:.3f} ms, plain (five eager passes) {tot['plain_ms']:.2f} ms",
          flush=True)
    return tot, rows


def phase_int8_main(results, card, dev, cfg, weights, batch, imgs, rng, inferer32, cpu32):
    """The int8 main path (phase 7) and its times (phase 8)."""
    import collections
    import tempfile

    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.ops import cuda_conv
    from yololp_tpu_torch.ops.nms import non_max_suppression, select_candidates
    from yololp_tpu_torch.quant import int8_infer
    from yololp_tpu_torch.quant.quantize import calibrate, load_amax, save_amax

    inferer8 = Inferer(".", weights, cfg, img_size=IMG, half=True, iou_thres=0.45,
                       max_det=1000, device=dev)
    batch2 = np.stack([inferer8.precess_image(im) for im in frames(rng)])
    t0 = time.perf_counter()
    amax = calibrate(inferer8.model, [batch, batch2], method="max", device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        save_amax(amax, os.path.join(tmp, "amax.json"))
        amax = load_amax(os.path.join(tmp, "amax.json"))
    print(f"calibrated {len(amax)} conv inputs (max, 2 batches of {BATCH}) in "
          f"{time.perf_counter() - t0:.1f} s; amax {min(amax.values()):.3g}..{max(amax.values()):.3g}")

    kw = dict(iou_thres=0.45, max_det=1000, conv_impl="pallas", device=dev)
    pred8 = int8_infer.make_int8_infer_fn(inferer8.model, inferer8.variables, amax,
                                          with_nms=False, **kw)(batch)
    anchors = pred8.shape[1]
    _, score_all, _ = select_candidates(pred8, 0.0, anchors)
    conf = float(score_all[:, min(2 * TOPK, anchors) - 1].min())
    inferer8.conf_thres = conf
    run8 = int8_infer.make_int8_infer_fn(inferer8.model, inferer8.variables, amax,
                                         conf_thres=conf, **kw)
    inferer8._run = run8
    inferer8.warmup()
    log = LaunchLog(run8.int8_model, int8_infer)

    quantized = []  # (x, inv_scale) of each float -> code quantize of the batch
    quantize = cuda_conv.quantize_codes

    def recorded(x, inv_scale):
        quantized.append((x, inv_scale))
        return quantize(x, inv_scale)

    cuda_conv.quantize_codes = recorded
    try:
        dets, (launches, nms_launches, q_launches) = counted(
            lambda: inferer8.detect_batch(imgs), "int8_conv", "greedy_nms", "quantize")
    finally:
        cuda_conv.quantize_codes = quantize
    log.remove()
    if launches < 30 or nms_launches < 1:
        raise AssertionError(f"int8 main path launched int8_conv {launches}x, greedy_nms {nms_launches}x")
    if launches != len(log.launches):
        raise AssertionError(f"{launches} int8_conv launches, {len(log.launches)} recorded")
    if not quantized or q_launches != len(quantized):
        raise AssertionError(f"int8 main path: {q_launches} quantize launches for "
                             f"{len(quantized)} float -> code quantizes")
    n_max = min(inferer8.max_det, TOPK)
    for d in dets:
        if d.ndim != 2 or d.shape[1] != 28 or len(d) > n_max or not np.isfinite(d).all():
            raise AssertionError(f"bad int8 detections {d.shape}")
    if len(dets) != BATCH or min(len(d) for d in dets) == 0:
        raise AssertionError("an image came back without detections on the int8 path")
    chain_launches = sum(links for _, _, _, links in CHAINS)
    print(f"int8 main path: yololps {IMG}px bf16, batch {BATCH}, conv_impl pallas, conf_thres {conf:.6f}, "
          f"int8_conv launches {launches} ({chain_launches} chain links), quantize launches "
          f"{q_launches} (one a float -> code quantize), greedy_nms launches {nms_launches}, "
          f"detections per image {min(map(len, dets))}..{max(map(len, dets))}")

    # the kernel on a chain link's own entry codes from the run
    path = "backbone/ERBlock_3_rep"
    blk = run8.int8_model.get_submodule(path.replace("/", "."))
    xq = log.chain_inputs[path]
    if xq.dtype != torch.int8:
        raise AssertionError(f"{path} took {xq.dtype}, not the handed-off int8 codes")
    w_q, a, b, dt = blk.fused[1][0]
    _, err = check_int8(cuda_conv, xq.permute(0, 2, 3, 1).contiguous(), w_q, a, b, 1, True, dt,
                        f"{path} link 0 on its own entry codes")
    print(f"int8_conv kernel == plain on {path} link 0's entry codes from the run "
          f"{tuple(xq.shape)} (codes {int(xq.min())}..{int(xq.max())})")

    pred8 = int8_infer.make_int8_infer_fn(inferer8.model, inferer8.variables, amax,
                                          with_nms=False, **kw)(batch)
    if pred8.shape != (BATCH, anchors, 290) or not torch.isfinite(pred8).all():
        raise AssertionError(f"int8 decode {tuple(pred8.shape)}")
    nkw = dict(conf_thres=conf, iou_thres=0.45, max_det=1000)
    card_out = non_max_suppression(pred8, **nkw)
    cpu_out = non_max_suppression(pred8.cpu(), **nkw)
    for name, a, b in zip(("det", "valid", "num"), card_out, cpu_out):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"card NMS != plain CPU NMS on the int8 decode ({name})")
    print(f"int8 decode: card NMS == plain CPU NMS; kept {int(cpu_out[2].min())}..{int(cpu_out[2].max())}")

    # one image, conv plan (exit handoffs on), fp32 with TF32 off: card vs CPU
    one = batch[:1]
    kw32 = dict(with_nms=False, conv_impl="conv")
    f_card = int8_infer.make_int8_infer_fn(inferer32.model, inferer32.variables, amax,
                                           device=dev, **kw32)
    f_cpu = int8_infer.make_int8_infer_fn(cpu32.model, cpu32.variables, amax, device="cpu", **kw32)
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, o, n=n: seen.append((n, a[0], o)))
             for n, m in f_card.int8_model.named_modules()
             if isinstance(m, (int8_infer.Int8Conv2d, int8_infer.Int8RepBlock))]
    p_card = f_card(one).cpu()
    for h in hooks:
        h.remove()
    p_cpu = f_cpu(one)
    cpu_mods = dict(f_cpu.int8_model.named_modules())
    with torch.inference_mode():
        for n, x_in, y in seen:
            if not torch.equal(cpu_mods[n](x_in.cpu()), y.cpu()):
                raise AssertionError(f"int8 module {n}: the CPU port on the card's input != the card")
        p_float = cpu32.predict(one)
    diff = [float((p_card[..., c] - p_cpu[..., c]).abs().max()) for c in (slice(0, 13), slice(13, None))]
    noise = [float((p_cpu[..., c] - p_float[..., c]).abs().max()) for c in (slice(0, 13), slice(13, None))]
    print(f"int8 fp32 (conv_impl conv, exit handoffs on), card (TF32 off) vs CPU port: each of the "
          f"{len(seen)} int8 modules, fed the card's own input, gives the card's output bit for bit")
    print(f"int8 fp32 decode, card vs CPU: max |diff| {diff[0]:.4g} px, {diff[1]:.4g} score; int8 "
          f"quantization noise on this image (int8 vs fp32 float model, CPU): {noise[0]:.4g} px, "
          f"{noise[1]:.4g} score")
    if not (diff[0] <= noise[0] and diff[1] <= noise[1]):
        raise AssertionError("the card-vs-CPU int8 decode differs by more than int8's own noise")
    err_px, err_score = diff

    # 8. times
    for _ in range(3):
        run8(batch)
    ms = cuda_ms(lambda: run8(batch), 2)
    img_s = BATCH * 1e3 / float(np.median(ms))
    print(f"[{card}] end-to-end int8 (pallas plan, bf16 exits) batch {BATCH}: {img_s:.1f} img/s "
          f"(median of 5 windows of 2 batches, {np.median(ms):.3f} ms per batch, CUDA events); "
          f"bf16 in this run: {results['e2e_bf16']['img_s']:.1f} img/s")
    profile = profile_batch(lambda: run8(batch), card, label="int8")
    kernel_dev_ms = sum(v for k, v in profile["by_name"].items() if "int8_conv_kernel" in k)
    print(f"[{card}] int8_conv kernels in the profiled batch: {kernel_dev_ms:.3f} ms of "
          f"{profile['window_ms']:.3f} ms ({100 * kernel_dev_ms / profile['window_ms']:.1f}%)")
    tot, rows = time_int8_launches(cuda_conv, collections.Counter(log.launches), rng, dev, card)
    print(f"[{card}] int8_conv, all {launches} launches of one batch timed alone: kernel "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.1f} ms, bound {tot['bound_ms']:.4f} ms, "
          f"cuDNN bf16 reference {tot['cudnn_bf16_ms']:.3f} ms")
    q_counts = recorded_quantize_counts(run8, batch)
    if q_counts != dict(spans=q_launches, fused=q_launches, launches=q_launches):
        raise AssertionError(f"a recorded int8 batch: {q_counts}, {q_launches} quantizes a batch")
    q_tot, q_rows = time_quantize_launches(quantized, card)
    del quantized
    q_tot.update(launches=q_launches, recorded=q_counts)
    results["int8"] = dict(launches=launches, nms_launches=nms_launches, conf_thres=conf,
                           fp32_err_px=err_px, fp32_err_score=err_score, fp32_noise=noise, median_ms=float(np.median(ms)),
                           img_s=img_s, runs_ms=ms, profile=profile, kernel_profile_ms=kernel_dev_ms,
                           per_batch=tot, launches_timed=rows, quantize=q_tot,
                           quantize_timed=q_rows)
    return launches, err, tot, dict(inferer8=inferer8, amax=amax, conf=conf)


def mm_bound(m, k, n, dtype):
    """(bound ms, bound_by, ops, bytes) of one (M, K) @ (K, N): each input
    byte read once, each output byte written once, 2 ops a multiply-add at
    the type's tensor-core peak."""
    es, peak = (1, INT8_OPS_S) if dtype == torch.int8 else (2, BF16_OPS_S)
    nbytes = (m * k + k * n) * es + m * n * 4
    ops = 2 * m * k * n
    t_b, t_o = nbytes / HBM_BYTES_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations"), ops, nbytes


def library_mm(a, b):
    """The one PyTorch call that computes a @ b for these inputs, or None:
    torch.matmul in bf16 (cuBLAS; its output is bf16, not fp32) and
    torch._int_mm in int8, which takes M > 16 and K, N multiples of 8. A
    yardstick only: the port never calls either."""
    if a.dtype == torch.bfloat16:
        return lambda: torch.matmul(a, b)
    if a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0:
        return lambda: torch._int_mm(a, b)
    return None


def time_matmul(cuda_matmul, a, b, reps=10, nt=False):
    """(kernel ms, plain ms, library ms or None) of a @ b (with `nt`,
    a @ b.T by matmul_nt), CUDA events, medians of 5 windows. The launcher
    is called directly, as phase 8 times int8_conv: a small launch sits on
    the host's floor, and the op's dispatch (phase 21) would add to it."""
    mm = cuda_matmul.matmul_nt_cuda if nt else cuda_matmul.matmul_cuda
    plain = cuda_matmul.matmul_nt_plain if nt else cuda_matmul.matmul_plain
    for _ in range(3):
        mm(a, b)
    ms = float(np.median(cuda_ms(lambda: mm(a, b), reps)))
    plain_ms = float(np.median(cuda_ms(lambda: plain(a, b), 1, 3)))
    lib = library_mm(a, b.t().contiguous() if nt else b)
    lib_ms = None
    if lib is not None:
        lib()
        lib_ms = float(np.median(cuda_ms(lib, reps)))
    return ms, plain_ms, lib_ms


def phase_dots_main(results, card, dev, batch, imgs, ctx):
    """10. The dots plan of the int8 main path against the conv plan."""
    import collections

    from yololp_tpu_torch.ops import cuda_conv
    from yololp_tpu_torch.quant import int8_infer

    inferer8, amax, conf = ctx["inferer8"], ctx["amax"], ctx["conf"]
    kw = dict(conf_thres=conf, iou_thres=0.45, max_det=1000, device=dev)
    plans = {}
    for impl in ("dots", "conv"):
        run = int8_infer.make_int8_infer_fn(inferer8.model, inferer8.variables, amax,
                                            conv_impl=impl, **kw)
        inferer8._run = run
        inferer8.warmup()
        log = LaunchLog(run.int8_model, int8_infer)
        dets, counts = counted(lambda: inferer8.detect_batch(imgs), "int8_conv", "mxu_matmul",
                               "greedy_nms")
        counts = tuple(counts)
        log.remove()
        mm_shapes, n_conv = collections.Counter(), 0
        for n, h, w, c, o, k, stride, _, _ in log.launches:
            if impl == "dots" and stride == 1:
                mm_shapes[(n * h * w, c, o, k)] += 9 if k == 3 else 1
            else:
                n_conv += 1
        want = (n_conv, sum(mm_shapes.values()), 1)
        if counts != want:
            raise AssertionError(f"{impl} plan launched (int8_conv, mxu_matmul, greedy_nms) "
                                 f"{counts}, its {len(log.launches)} int8 convs imply {want}")
        if len(dets) != BATCH or min(len(d) for d in dets) == 0:
            raise AssertionError(f"an image came back without detections on the {impl} plan")
        for d in dets:
            if d.ndim != 2 or d.shape[1] != 28 or not np.isfinite(d).all():
                raise AssertionError(f"bad {impl} detections {d.shape}")
        for _ in range(3):
            run(batch)
        ms = cuda_ms(lambda: run(batch), 2)
        plans[impl] = dict(dets=dets, counts=counts, mm_shapes=mm_shapes, log=log, run=run,
                           runs_ms=ms, median_ms=float(np.median(ms)),
                           img_s=BATCH * 1e3 / float(np.median(ms)))
        print(f"int8 main path, conv_impl {impl}: int8_conv launches {counts[0]}, mxu_matmul "
              f"launches {counts[1]}, greedy_nms launches {counts[2]} (as the {len(log.launches)} "
              f"int8 convs imply); detections per image {min(map(len, dets))}..{max(map(len, dets))}")

    for i, (d, c) in enumerate(zip(plans["dots"]["dets"], plans["conv"]["dets"])):
        if d.shape != c.shape or not np.array_equal(d, c):
            raise AssertionError(f"image {i}: the dots plan's detections != the conv plan's")
    print(f"dots plan detections == conv plan detections, bit for bit, on all {BATCH} images")

    # the dots route on a chain link's own entry codes from the run
    path = "backbone/ERBlock_3_rep"
    dots = plans["dots"]
    xq = dots["log"].chain_inputs[path]
    blk = dots["run"].int8_model.get_submodule(path.replace("/", "."))
    x_nhwc, w_q = xq.permute(0, 2, 3, 1).contiguous(), blk.plan[1][0][0]
    acc = int8_infer._int8_conv(x_nhwc, w_q, 1, 1, "dots")
    if xq.dtype != torch.int8 or not torch.equal(acc, cuda_conv.int8_conv_acc_plain(x_nhwc, w_q)):
        raise AssertionError(f"dots route != exact accumulator on {path} link 0's entry codes")
    print(f"dots route (9 mxu_matmul launches) == exact accumulator on {path} link 0's entry "
          f"codes from the run {tuple(xq.shape)}")
    for impl in ("dots", "conv"):
        print(f"[{card}] end-to-end int8 ({impl} plan) batch {BATCH}: {plans[impl]['img_s']:.1f} "
              f"img/s ({plans[impl]['median_ms']:.3f} ms per batch, median of 5 windows of 2, CUDA "
              f"events); in this run bf16 {results['e2e_bf16']['img_s']:.1f}, int8 pallas plan "
              f"{results['int8']['img_s']:.1f}")
    results["dots"] = {impl: dict(counts=p["counts"], runs_ms=p["runs_ms"], median_ms=p["median_ms"],
                                  img_s=p["img_s"]) for impl, p in plans.items()}
    profile = profile_batch(lambda: dots["run"](batch), card, label="int8 dots-plan")
    mm_dev_ms = sum(v for k, v in profile["by_name"].items() if "mxu_matmul_kernel" in k)
    print(f"[{card}] mxu_matmul kernels in the profiled dots batch: {mm_dev_ms:.3f} ms of "
          f"{profile['window_ms']:.3f} ms ({100 * mm_dev_ms / profile['window_ms']:.1f}%)")
    results["dots"]["profile"] = profile
    return dots["counts"][1], dots["mm_shapes"]


def phase_matmul_times(results, card, dev, rng, mm_shapes, amax, model):
    """11. The matmul launches of one dots batch and the probe's shapes,
    timed alone; then each ported measurement tool once."""
    import tempfile

    from yololp_tpu_torch.ops import cuda_matmul
    from yololp_tpu_torch.quant.quantize import save_amax
    from yololp_tpu_torch.tools import (bench_nms, probe_int8_e2e, probe_latency, probe_mxu_int8,
                                        probe_pallas_conv, probe_train_mfu, profile_int8,
                                        profile_sections, profile_train)
    from yololp_tpu_torch.utils.profiler import model_flops

    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, ops=0, bytes=0,
               library_launches=0, launches=0)
    rows, plans = [], {}
    for (m, k, n, kh), count in sorted(mm_shapes.items(), key=lambda kv: -kv[0][0] * kv[0][2]):
        # as the dots plan passes them: a 3x3 tap's strided weight view, a
        # 1x1's contiguous (O, C) weights
        a, b = matmul_operands(rng, m, k, n, torch.int8, "tap" if kh == 3 else "nt", dev)
        ms, plain_ms, lib_ms = time_matmul(cuda_matmul, a, b, nt=True)
        bound_ms, bound_by, ops, nbytes = mm_bound(m, k, n, torch.int8)
        plans[f"N={n}"] = cuda_matmul.plan(n)
        rows.append(dict(shape=[m, k, n], kernel_size=kh, launches=count, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms))
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            tot[key] += count * v
        tot["ops"] += count * ops
        tot["bytes"] += count * nbytes
        tot["launches"] += count
        if lib_ms is not None:
            tot["library_ms"] += count * lib_ms
            tot["library_launches"] += count
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none (torch._int_mm refuses the shape)"
        print(f"[{card}] mxu_matmul int8 ({m}, {k}) @ ({k}, {n}) ({kh}x{kh} conv): x{count}/batch (dots plan), kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% of it), torch._int_mm {lib}")
    tot["bound_by"] = "bytes" if tot["bytes"] / HBM_BYTES_S > tot["ops"] / INT8_OPS_S else "operations"
    print(f"[{card}] mxu_matmul, all {tot['launches']} launches of one dots batch timed alone: "
          f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.1f} ms, bound {tot['bound_ms']:.4f} ms "
          f"by {tot['bound_by']}, torch._int_mm {tot['library_ms']:.3f} ms over the "
          f"{tot['library_launches']} launches it takes")

    probe = []
    for m, k, n in MM_PROBE:
        for dt in (torch.bfloat16, torch.int8):
            a, b = matmul_operands(rng, m, k, n, dt, dev=dev)
            ms, plain_ms, lib_ms = time_matmul(cuda_matmul, a, b, reps=20)
            bound_ms, bound_by, ops, _ = mm_bound(m, k, n, dt)
            probe.append(dict(shape=[m, k, n], dtype=str(dt)[6:], ms=ms, rate_t=ops / ms / 1e9,
                              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=lib_ms, library_rate_t=ops / lib_ms / 1e9))
            lib = "torch.matmul (bf16 out)" if dt == torch.bfloat16 else "torch._int_mm"
            print(f"[{card}] mxu_matmul {str(dt)[6:]} ({m}, {k}) @ ({k}, {n}): kernel {ms:.4f} ms "
                  f"({ops / ms / 1e9:.1f} T/s), bound {bound_ms:.4f} ms by {bound_by} "
                  f"({100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.3f} ms, {lib} {lib_ms:.4f} ms "
                  f"({ops / lib_ms / 1e9:.1f} T/s)")
    for m, k, n in MM_PROBE:
        plans[f"N={n}"] = cuda_matmul.plan(n)
    print(f"[{card}] mxu_matmul tiles:")
    report = kernel_report("mxu_matmul", plans)
    results["matmul"] = dict(dots_batch=tot, dots_launches_timed=rows, probe=probe,
                             kernel=report)

    # each ported measurement tool once, at small step counts and batch 32
    x = torch.zeros(BATCH, 3, IMG, IMG, device=dev, dtype=torch.bfloat16)
    flops = model_flops(torch.inference_mode()(model), x.contiguous(memory_format=torch.channels_last))
    print(f"[{card}] model_flops, bf16 forward batch {BATCH}: {flops['flops'] / 1e9:.1f} GFLOP, "
          f"peak memory {flops['peak_memory_bytes'] / 2 ** 20:.0f} MiB")
    tools = {"model_flops": flops}
    with tempfile.TemporaryDirectory() as tmp:
        calib = os.path.join(tmp, "amax.json")
        save_amax(amax, calib)
        for name, fn, argv in (
                ("probe_mxu_int8", probe_mxu_int8.main, ["--iters", "4"]),
                ("probe_pallas_conv", probe_pallas_conv.main, ["--iters", "4", "--batch", str(BATCH)]),
                ("profile_int8", profile_int8.main, ["--iters", "6", "--batch-size", str(BATCH),
                                                     "--calib-pt", calib]),
                ("probe_latency", probe_latency.main, ["--iters", "2", "--batches", f"1,{BATCH}",
                                                       "--int8"]),
                ("profile_sections", profile_sections.main, ["--iters", "2", "--batch-size",
                                                             str(BATCH), "--calib-pt", calib]),
                ("bench_nms", bench_nms.main, ["--iters", "4", "--batch-size", str(BATCH)]),
                ("profile_train", profile_train.main, ["--iters", "2", "--batch-size", str(BATCH)]),
                ("probe_train_mfu", probe_train_mfu.main, ["--iters", "2",
                                                           "--shapes", f"{BATCH}x{IMG}"]),
                ("probe_int8_e2e", probe_int8_e2e.main, ["--iters", "4", "--batch-size",
                                                         str(BATCH), "--calib-pt", calib])):
            t0 = time.perf_counter()
            print(f"[{card}] {name}.main({argv}):", flush=True)
            tools[name] = fn(["--device", "cuda"] + argv)
            print(f"[{card}] {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    results["tools"] = tools
    return tot


def self_labels(preds, size, max_boxes):
    """Labels (n, max_boxes, 20) and masks, as labelled_frames gives them,
    of each frame's detections (k, 28) in pixels: the first max_boxes of
    them (the highest scores), each clipped to the frame."""
    labels = np.zeros((len(preds), max_boxes, 20), np.float32)
    labels[..., :8] = -1
    masks = np.zeros((len(preds), max_boxes), np.float32)
    for i, det in enumerate(preds):
        det = det[:max_boxes]
        box = np.clip(det[:, :4], 0, size) / size
        keep = (box[:, 2] - box[:, 0] > 1e-3) & (box[:, 3] - box[:, 1] > 1e-3)
        det, box = det[keep], box[keep]
        k = len(det)
        labels[i, :k, :8] = det[:, 20:28]
        labels[i, :k, 8:12] = np.concatenate([(box[:, :2] + box[:, 2:]) / 2,
                                              box[:, 2:] - box[:, :2]], 1)
        labels[i, :k, 12:20] = np.clip(det[:, 4:12], 0, size) / size
        masks[i, :k] = 1
    return labels, masks


def phase_eval(results, card, dev, inferer, ctx8):
    """12. Evaler.predict and Evaler.eval on the card: 70 in-memory frames
    at 640 in loader batches of 32 (the tail of 6 padded), bf16 and then the
    int8 pallas plan on phase 7's calibration."""
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.quant import int8_infer

    imgs, labels, masks = labelled_frames(np.random.default_rng(SEED + 12), EVAL_FRAMES, IMG)
    loader = loader_batches(imgs, labels, masks, BATCH)
    ev = Evaler({}, batch_size=BATCH, img_size=IMG, conf_thres=inferer.conf_thres, device=dev)
    out = {}
    runs = [("bf16", ev.make_infer_fn(inferer.model), inferer.model, ("greedy_nms",))]
    inferer8 = ctx8["inferer8"]
    run8 = int8_infer.make_int8_infer_fn(inferer8.model, inferer8.variables, ctx8["amax"],
                                         conf_thres=ev.conf_thres, iou_thres=ev.iou_thres,
                                         max_det=ev.max_det, conv_impl="pallas", device=dev)
    runs.append(("int8 pallas", run8, run8.int8_model, ("greedy_nms", "int8_conv")))
    for label, run_fn, module, kernels in runs:
        ev.predict(run_fn, loader[:1])  # warm-up
        ev.speed_result = np.zeros(4)
        metric, launches, preds, metric_own, _ = eval_on_card(ev, run_fn, module, loader,
                                                              kernels)
        if any(n < 1 for n in launches.values()):
            raise AssertionError(f"eval ({label}) launched {launches}")
        if len(preds) != EVAL_FRAMES or sum(map(len, preds)) == 0:
            raise AssertionError(f"eval ({label}): {len(preds)} images, {sum(map(len, preds))} dets")
        speed = ev.eval_speed()
        print(f"eval ({label}), yololps {IMG}px, {EVAL_FRAMES} frames in batches of {BATCH} "
              f"(tail {EVAL_FRAMES % BATCH} padded), conf_thres {ev.conf_thres:.6f}, iou_thres "
              f"{ev.iou_thres}: launches {launches}, detections {sum(map(len, preds))}; metric == "
              f"the plain CPU NMS's on the card's decode")
        print(f"  metric [mAP, mAP50, mAP75, mAP50-95, recall, AP per bucket, recall per bucket]: "
              f"{json.dumps(metric)}")
        print(f"  metric with each image's first two detections as its gts (equal on the card "
              f"and the plain CPU NMS): {json.dumps(metric_own)}")
        print(f"[{card}] eval_speed ({label}) ms per image: {json.dumps(speed)}")
        out[label] = dict(metric=metric, metric_own_gts=metric_own, launches=launches,
                          speed=speed, detections=int(sum(map(len, preds))))
    results["eval"] = out
    return out


def fg_report(labels, masks, lcfg, fg_a, fg_b, dev):
    """Each anchor whose fg differs between the card and the CPU: its IoU
    with every real gt beside that gt's ATSS threshold on both."""
    from yololp_tpu_torch.assigners import atss
    from yololp_tpu_torch.losses.loss import prepare_targets
    from yololp_tpu_torch.ops.anchors import anchors_train
    from yololp_tpu_torch.ops.geometry import pairwise_iou_mmdet

    thr = {}
    for d in (dev, torch.device("cpu")):
        anchors, _, n_list, _ = anchors_train(lcfg.img_size, lcfg.strides, device=d)
        _, _, _, gt_bboxes, _, mask_gt = prepare_targets(torch.from_numpy(labels),
                                                         torch.from_numpy(masks), lcfg.img_size, d)
        b, m = gt_bboxes.shape[:2]
        overlaps = pairwise_iou_mmdet(gt_bboxes.reshape(-1, 4), anchors).reshape(b, m, -1)
        dist, _ = atss._center_distances(gt_bboxes, anchors)
        is_in, cand = atss._select_topk_candidates(dist, tuple(n_list), mask_gt, lcfg.topk)
        thr[d.type] = (atss._threshold(is_in, cand, overlaps)[0].cpu(), overlaps.cpu(), mask_gt.cpu())
    for bi, ai in torch.nonzero(fg_a != fg_b).tolist():
        for mi in torch.nonzero(thr["cpu"][2][bi, :, 0]).flatten().tolist():
            print(f"  fg differs at image {bi} anchor {ai}: gt {mi} IoU card "
                  f"{float(thr['cuda'][1][bi, mi, ai])!r} cpu {float(thr['cpu'][1][bi, mi, ai])!r}, "
                  f"threshold card {float(thr['cuda'][0][bi, mi, 0])!r} cpu {float(thr['cpu'][0][bi, mi, 0])!r}")


def phase_train(results, card, dev, train_model, cfg, name="yololps", n_time=BATCH, key="train",
                seed=SEED + 13):
    """13 (and 16). The train forward, ATSS assignment, loss and backward of
    `name`: fp32 parity of the card with the CPU at batch 2, then times at
    batch `n_time` under autocast(bfloat16); results under `key`."""
    import copy

    from yololp_tpu_torch.losses.loss import LossConfig, assign, compute_loss, loss_terms
    from yololp_tpu_torch.ops.division import unit_pixels

    head = cfg["model"]["head"]
    lcfg = LossConfig(img_size=(IMG, IMG), strides=tuple(head["strides"]),
                      use_dfl=bool(head["use_dfl"]), reg_max=int(head["reg_max"]),
                      iou_type=head["iou_type"], assigner="atss")
    imgs, labels, masks = labelled_frames(np.random.default_rng(seed), n_time, IMG)

    # parity: fp32 with TF32 off, batch 2, card against the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def step(model, d, n):
        # contiguous NCHW: a channels_last backward at 640 corrupts the heap in
        # the CPU build of torch 2.13 (an abort, found rehearsing this phase)
        x = unit_pixels(torch.from_numpy(imgs[:n]).to(d).permute(0, 3, 1, 2),
                        torch.float32).contiguous()
        out = model(x)
        out.reg.retain_grad()
        out.cor.retain_grad()
        total, items, fg = compute_loss(out, torch.from_numpy(labels[:n]),
                                        torch.from_numpy(masks[:n]), lcfg, with_fg=True)
        total.backward()
        return [t.detach().cpu() for t in (total, items, fg, out.reg.grad, out.cor.grad)]

    t0 = time.perf_counter()
    got = step(copy.deepcopy(train_model).to(dev).train(), dev, TRAIN_PARITY_BATCH)
    want = step(copy.deepcopy(train_model).train(), "cpu", TRAIN_PARITY_BATCH)
    if not torch.equal(got[2], want[2]):
        fg_report(labels[:TRAIN_PARITY_BATCH], masks[:TRAIN_PARITY_BATCH], lcfg, got[2], want[2], dev)
        raise AssertionError("the fg masks of the card and the CPU differ")
    items_err = float(((got[1] - want[1]).abs() / want[1].abs().clamp(min=1e-12)).max())
    total_err = float((got[0] - want[0]).abs() / want[0].abs())
    grad_err = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got[3:], want[3:])]
    print(f"train parity, {name} {IMG}px fp32 (TF32 off), batch {TRAIN_PARITY_BATCH}, card vs CPU "
          f"({time.perf_counter() - t0:.1f} s): fg masks equal ({int(want[2].sum())} fg anchors); "
          f"loss items {[round(float(v), 6) for v in want[1]]}, max rel diff {items_err:.3g}, total "
          f"{float(want[0]):.6f} rel diff {total_err:.3g}; d total / d reg, d cor: max |diff| / max "
          f"|grad| {grad_err[0]:.3g}, {grad_err[1]:.3g}")
    if not (items_err <= TRAIN_LOSS_RTOL and total_err <= TRAIN_LOSS_RTOL
            and max(grad_err) <= TRAIN_GRAD_TOL):
        raise AssertionError(f"train parity beyond rtol {TRAIN_LOSS_RTOL} (loss) / "
                             f"{TRAIN_GRAD_TOL} (grads)")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # times: forward, assign, loss, backward at batch 32 in bf16 (fp32 params)
    model = copy.deepcopy(train_model).to(dev).to(memory_format=torch.channels_last).train()
    x = unit_pixels(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2), torch.float32)
    lab, msk = torch.from_numpy(labels).to(dev), torch.from_numpy(masks).to(dev)

    def one_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = model(x)
        ev[1].record()
        asg = assign(out, lab, msk, lcfg)
        ev[2].record()
        total, _ = loss_terms(out, asg, lcfg)
        ev[3].record()
        total.backward()
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    for _ in range(2):
        one_step()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = np.array([one_step() for _ in range(TRAIN_STEPS)])
    peak = torch.cuda.max_memory_allocated(dev)
    parts = dict(zip(("forward", "assign", "loss", "backward"), np.median(steps, 0).tolist()))
    step_ms = float(np.median(steps.sum(1)))
    print(f"[{card}] train step (forward, ATSS assign, loss, backward; no optimizer), {name} "
          f"{IMG}px batch {n_time}, autocast bf16 with fp32 params: {step_ms:.3f} ms per step "
          f"(median of {TRAIN_STEPS}, CUDA events), {n_time * 1e3 / step_ms:.1f} img/s; ms by part "
          f"{json.dumps({k: round(v, 3) for k, v in parts.items()})}; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB")
    results[key] = dict(parity=dict(items=want[1].tolist(), items_rel_err=items_err,
                                    total_rel_err=total_err, grad_err=grad_err,
                                    fg=int(want[2].sum())),
                        step_ms=step_ms, img_s=n_time * 1e3 / step_ms, parts_ms=parts,
                        steps_ms=steps.tolist(), peak_bytes=peak)
    return results[key]


def state_numpy(state, which):
    """{name: array} of a TrainState's params + stats, EMA, or momentum."""
    names = state.names + state.stat_names if which != "momentum" else state.names
    tensors = {"params": state.params + state.batch_stats, "ema": state.ema_params + state.ema_stats,
               "momentum": state.momentum}[which]
    return {n: t.detach().float().cpu().numpy().copy() for n, t in zip(names, tensors)}


@torch.no_grad()
def copy_state(dst, src):
    """Every tensor and count of TrainState `src` into `dst` (another device)."""
    for name in ("params", "batch_stats", "momentum", "grad_accum", "ema_params", "ema_stats"):
        for a, b in zip(getattr(dst, name), getattr(src, name)):
            a.copy_(b)
    dst.ema_updates, dst.step, dst.last_opt_step = src.ema_updates, src.step, src.last_opt_step


def update_errors(got, want, start):
    """Per tensor max |update_got - update_want| over the allowed bound; BN
    statistics relative to their values. Returns the worst ratio and name."""
    upd = {k: w - start[k] for k, w in want.items()}
    floor = TRAIN_UPDATE_FLOOR * max(float(np.abs(u).max()) for u in upd.values())
    worst = (0.0, "")
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            r = float(np.abs(got[k] - w).max() / (TRAIN_LOSS_RTOL * np.abs(w).max() + 5e-3))
        else:
            r = float(np.abs((got[k] - start[k]) - upd[k]).max()
                      / (TRAIN_UPDATE_TOL * np.abs(upd[k]).max() + floor + 1e-30))
        worst = max(worst, (r, k))
    return worst


def write_memo_dataset(root, imgs, labels, masks):
    """A train set held as the device cache's memos: one placeholder file a
    frame under images/train (the scan stats it, never decodes it), its
    labels under labels/train, and the .npy memos precompute_items reads."""
    from yololp_tpu_torch.data.datasets import TrainValDataset
    from yololp_tpu_torch.data.device_cache import memo_paths

    img_dir = os.path.join(root, "images", "train")
    lbl_dir = os.path.join(root, "labels", "train")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    for i in range(len(imgs)):
        with open(os.path.join(img_dir, f"frame{i:04d}.jpg"), "wb") as f:
            f.write(b"memo")
        with open(os.path.join(lbl_dir, f"frame{i:04d}.txt"), "w") as f:
            for row in labels[i][masks[i] > 0]:
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    ds = TrainValDataset(img_dir, img_size=IMG, augment=False, task="train")
    padded = [ds._pad(lbl) for lbl in ds.labels]
    paths = memo_paths(ds)
    np.save(paths["images"], imgs)
    np.save(paths["labels"], np.stack([p[0] for p in padded]))
    np.save(paths["masks"], np.stack([p[1] for p in padded]))
    return img_dir


def phase_training(results, card, dev, train_model, cfg, amax, eval_frames):
    """14. The train step with the optimizer (parity, accumulation, QAT),
    its times, a cached epoch, and the Trainer for 2 epochs with its
    checkpoint and evals on the card."""
    import copy
    import tempfile
    import types

    from yololp_tpu_torch.core.engine import Trainer
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
    from yololp_tpu_torch.data.device_cache import make_cached_epoch
    from yololp_tpu_torch.layers.fuse import fuse_state_dict
    from yololp_tpu_torch.losses.loss import LossConfig, assign, loss_terms
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.ops.division import unit_pixels
    from yololp_tpu_torch.solver.build import (SolverConfig, accumulate_steps, ema_update,
                                               label_groups, schedule, sgd_apply, warmup_steps)
    from yololp_tpu_torch.utils.checkpoint import load_inference_variables
    from yololp_tpu_torch.utils.convert import load_state_dict_strict

    head, sol = cfg["model"]["head"], cfg["solver"]
    lcfg = LossConfig(img_size=(IMG, IMG), strides=tuple(head["strides"]),
                      use_dfl=bool(head["use_dfl"]), reg_max=int(head["reg_max"]),
                      iou_type=head["iou_type"], assigner="atss")
    # the config's solver; warmup_bias_lr 0.01 (not 0.1) keeps the first
    # steps of a random net gentle, so that fp32 rounding does not grow into
    # the next steps' losses
    scfg = SolverConfig(lr0=sol["lr0"], lrf=sol["lrf"], momentum=sol["momentum"],
                        weight_decay=sol["weight_decay"], warmup_epochs=sol["warmup_epochs"],
                        warmup_momentum=sol["warmup_momentum"], warmup_bias_lr=0.01,
                        lr_scheduler=sol["lr_scheduler"], epochs=10, steps_per_epoch=100)
    imgs, labels, masks = labelled_frames(np.random.default_rng(SEED + 14), TRAINER_FRAMES, IMG)
    out = {}

    # parity: fp32, TF32 off, batch 2, 3 steps from step 0; each step runs
    # on the card and on the CPU from the card's state before it (a random
    # net in train mode is chaotic: rounding differences compound over steps)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = TRAIN_PARITY_BATCH
    states, steps = [], []
    for d in (dev, torch.device("cpu")):
        model = copy.deepcopy(train_model).to(d)
        states.append(init_train_state(model))
        steps.append(make_train_step(model, lcfg, scfg, batch_size=n))
    card_state, cpu_state = states
    items, worst = [], {w: (0.0, "") for w in ("params", "ema", "momentum")}
    t0 = time.perf_counter()
    for i in range(3):
        copy_state(cpu_state, card_state)
        start = {w: state_numpy(card_state, w) for w in worst}
        sl = slice(i * n, (i + 1) * n)
        pair = []
        for j, st in enumerate(states):
            st, total, it = steps[j](st, imgs[sl], labels[sl], masks[sl])
            pair.append(torch.cat([total.reshape(1), it]).cpu().numpy())
        items.append(pair)
        for w in worst:
            worst[w] = max(worst[w], update_errors(state_numpy(card_state, w),
                                                   state_numpy(cpu_state, w), start[w]))
    items = np.asarray(items)  # (steps, card|cpu, 8)
    items_err = float(np.max(np.abs(items[:, 0] - items[:, 1]) / np.maximum(np.abs(items[:, 1]), 1e-12)))
    counts = [(st.ema_updates, st.step, st.last_opt_step) for st in states]
    print(f"train_step parity, yololps {IMG}px fp32 (TF32 off), batch {n}, 3 steps from step 0, "
          f"each from the card's state on both, card vs CPU ({time.perf_counter() - t0:.1f} s): "
          f"[total + 7 items] per step {json.dumps(np.round(items[:, 1], 6).tolist())}, max rel "
          f"diff {items_err:.3g}; counts {counts}; worst update / bound: "
          + ", ".join(f"{w} {r:.3g} ({k})" for w, (r, k) in worst.items()))
    if counts[0] != counts[1] or counts[0] != (3, 3, 2):
        raise AssertionError(f"optimizer counts card {counts[0]} CPU {counts[1]}, expected (3, 3, 2)")
    if not (items_err <= TRAIN_LOSS_RTOL and all(r <= 1.0 for r, _ in worst.values())):
        raise AssertionError(f"train_step parity beyond rtol {TRAIN_LOSS_RTOL} (loss) / "
                             f"{TRAIN_UPDATE_TOL} of the largest update: {worst}")
    out["parity"] = dict(items=items[:, 1].tolist(), items_rel_err=items_err,
                         worst_update={w: list(v) for w, v in worst.items()})
    del states, steps, card_state, cpu_state

    # one QAT step from the same state on both: with phase 7's amax (every
    # calibrated conv input fake-quantized), and with the network input alone
    # fake-quantized (the codes equal on both, so the steps can be held)
    qat = {}
    stem = {"backbone/stem/rbr_dense_conv": 0.8125, "backbone/stem/rbr_1x1_conv": 0.8125}
    for label, q_amax in (("phase 7 amax", amax), ("input only", stem)):
        runs = []
        for d in (dev, torch.device("cpu")):
            model = copy.deepcopy(train_model).to(d)
            state = init_train_state(model)
            step = make_train_step(model, lcfg, scfg, batch_size=n, quant_amax=q_amax)
            state, total, it = step(state, imgs[:n], labels[:n], masks[:n])
            runs.append(torch.cat([total.reshape(1), it]).cpu().numpy())
        err = float(np.max(np.abs(runs[0] - runs[1]) / np.maximum(np.abs(runs[1]), 1e-12)))
        qat[label] = dict(card=runs[0].tolist(), cpu=runs[1].tolist(), rel_err=err)
        print(f"QAT train_step, {label} ({len(q_amax)} conv inputs fake-quantized, every kernel per "
              f"output channel, straight-through gradient), batch {n}: [total + 7 items] card "
              f"{json.dumps(np.round(runs[0], 6).tolist())}, CPU max rel diff {err:.3g}")
        if not np.isfinite(runs[0]).all():
            raise AssertionError(f"QAT step ({label}): non-finite loss on the card {runs[0]}")
    # a fake-quant is a step function: conv sums in another order move a few
    # values across a code's edge, and in a deep random net each flip spreads
    # (tests/test_torch_qat.py); the input-only case has equal codes
    if qat["input only"]["rel_err"] > TRAIN_LOSS_RTOL:
        raise AssertionError(f"QAT step (input only): card vs CPU beyond rtol {TRAIN_LOSS_RTOL}")
    out["qat"] = qat
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # accumulation past warmup at batch 32 (nominal 2): the optimizer applies
    # on exactly the micro-steps the host predicts
    model = copy.deepcopy(train_model).to(dev).to(memory_format=torch.channels_last)
    state = init_train_state(model)
    step = make_train_step(model, lcfg, scfg, batch_size=BATCH, dtype=torch.bfloat16)
    state.step = warmup_steps(scfg) + 1
    state.last_opt_step = state.step - 1
    applied, predicted = [], []
    probe = state.params[0]
    acc = accumulate_steps(scfg, BATCH, state.step)
    for i in range(2 * acc):
        s0 = state.step
        predicted.append(s0 - state.last_opt_step >= accumulate_steps(scfg, BATCH, s0))
        before = probe.detach().clone()
        state, total, _ = step(state, imgs[:BATCH], labels[:BATCH], masks[:BATCH])
        applied.append(bool((probe.detach() != before).any()) and state.last_opt_step == s0)
        if not torch.isfinite(total):
            raise AssertionError("non-finite loss in the accumulation run")
    print(f"accumulation past warmup (step {warmup_steps(scfg) + 1}.., batch {BATCH}, "
          f"accumulate {acc}): optimizer applied {applied}, host predicted {predicted}")
    if applied != predicted or applied != ([False] * (acc - 1) + [True]) * 2:
        raise AssertionError(f"optimizer applied {applied}, predicted {predicted}")

    # times at batch 32, autocast bf16, fp32 master parameters
    x = unit_pixels(torch.from_numpy(imgs[:BATCH]).to(dev).permute(0, 3, 1, 2), torch.bfloat16)
    lab = torch.from_numpy(labels[:BATCH]).to(dev)
    msk = torch.from_numpy(masks[:BATCH]).to(dev)
    groups = [label_groups(model)[k] for k in state.names]

    def timed_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            o = model(x)
        ev[1].record()
        asg = assign(o, lab, msk, lcfg)
        ev[2].record()
        total, _ = loss_terms(o, asg, lcfg)
        ev[3].record()
        total.backward()
        ev[4].record()
        lr_w, lr_b, mom = schedule(scfg, state.step)
        sgd_apply(state.params, state.grad_accum, state.momentum, groups, lr_w, lr_b, mom,
                  scfg.weight_decay)
        state.ema_updates += 1
        ema_update(state.ema_params, state.params, state.ema_updates)
        ema_update(state.ema_stats, state.batch_stats, state.ema_updates)
        torch._foreach_zero_(state.grad_accum)
        ev[5].record()
        ev[5].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

    for _ in range(2):
        timed_step()
    torch.cuda.reset_peak_memory_stats(dev)
    parts = np.array([timed_step() for _ in range(TRAIN_STEPS)])
    peak = torch.cuda.max_memory_allocated(dev)
    whole = cuda_ms(lambda: step(state, imgs[:BATCH], labels[:BATCH], masks[:BATCH]), 1)
    names = ("forward", "assign", "loss", "backward", "sgd_ema")
    part_ms = dict(zip(names, np.median(parts, 0).tolist()))
    step_ms = float(np.median(parts.sum(1)))
    n_params = sum(p.numel() for p in state.params)
    print(f"[{card}] train step with the optimizer (Nesterov SGD + EMA of {len(state.params)} "
          f"tensors, {n_params / 1e6:.1f} M parameters), yololps {IMG}px batch {BATCH}, autocast bf16, "
          f"fp32 master parameters: {step_ms:.3f} ms per step (median of {TRAIN_STEPS}, CUDA "
          f"events), {BATCH * 1e3 / step_ms:.1f} img/s; ms by part "
          f"{json.dumps({k: round(v, 3) for k, v in part_ms.items()})}; `train_step` as called "
          f"{float(np.median(whole)):.3f} ms (median of 5 windows); max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; phase 13 without the optimizer "
          f"{results['train']['step_ms']:.3f} ms")

    # one cached epoch: 4 steps over 128 frames staged flat on the card
    images_all = torch.from_numpy(imgs.reshape(len(imgs), -1)).to(dev)
    labels_all, masks_all = torch.from_numpy(labels).to(dev), torch.from_numpy(masks).to(dev)
    epoch_fn = make_cached_epoch(step, imgs.shape[1:])
    idx = np.random.default_rng(SEED).permutation(len(imgs)).reshape(-1, BATCH)
    epoch_fn(state, images_all, labels_all, masks_all, torch.from_numpy(idx[:1]))  # warm-up
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    state, items_sum = epoch_fn(state, images_all, labels_all, masks_all, torch.from_numpy(idx))
    e1.record()
    e1.synchronize()
    epoch_ms = e0.elapsed_time(e1)
    if not torch.isfinite(items_sum).all():
        raise AssertionError(f"cached epoch loss items {items_sum}")
    print(f"[{card}] cached epoch, {len(idx)} steps of {BATCH} over {len(imgs)} frames on the "
          f"card: {epoch_ms:.3f} ms, {epoch_ms / len(idx):.3f} ms per step")
    out.update(step_ms=step_ms, img_s=BATCH * 1e3 / step_ms, parts_ms=part_ms,
               train_step_ms=float(np.median(whole)), peak_bytes=peak, steps_ms=parts.tolist(),
               cached_epoch_ms_per_step=epoch_ms / len(idx))
    del model, state, step, epoch_fn, images_all
    torch.cuda.empty_cache()

    # the Trainer: 2 epochs, --cache-device over memos, eval every epoch
    ev_imgs, ev_labels, ev_masks = eval_frames
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = write_memo_dataset(tmp, imgs, labels, masks)
        tcfg = copy.deepcopy(cfg)
        tcfg["data_aug"] = {k: 0.0 for k in cfg["data_aug"]}
        args = types.SimpleNamespace(
            img_size=IMG, batch_size=BATCH, epochs=TRAINER_EPOCHS, workers=0,
            save_dir=os.path.join(tmp, "run"), conf_file="yololps", seed=SEED, bf16=True,
            cache_device=True, assigner=None, stop_aug_last_n_epoch=15, eval_interval=1,
            heavy_eval_range=50, quant=False, calib=False, distill=False, device=dev,
            epochs_per_dispatch=1)
        t0 = time.perf_counter()
        trainer = Trainer(args, tcfg, {"train": img_dir, "val": img_dir})
        sd = {k: v for k, v in train_model.state_dict().items() if not k.endswith("num_batches_tracked")}
        trainer.state.load(sd, sd, {}, ema_updates=0, step=0, last_opt_step=-1_000_000)
        ev = Evaler({}, batch_size=BATCH, img_size=IMG, conf_thres=0.0, device=dev)
        eval_model = trainer._deploy_model()
        trainer._eval_cache = (eval_model, ev, loader_batches(ev_imgs, ev_labels, ev_masks, BATCH),
                               ev.make_infer_fn(eval_model))
        evals = []
        eval_model_fn = trainer.eval_model

        def counted_eval():
            res, (n,) = counted(eval_model_fn, "greedy_nms")
            evals.append(n)
            return res

        trainer.eval_model = counted_eval
        trainer.train()
        train_s = time.perf_counter() - t0
        log = [json.loads(line) for line in open(trainer.log_path)]
        wdir = os.path.join(args.save_dir, "weights")
        saved = sorted(os.listdir(wdir))
        print(f"[{card}] Trainer, yololps {IMG}px batch {BATCH} bf16, {TRAINER_EPOCHS} epochs of "
              f"{trainer.steps_per_epoch} steps (--cache-device over {len(imgs)} memo frames), eval "
              f"each epoch on {len(ev_imgs)} frames: {train_s:.1f} s in all; epoch_time_s "
              f"{[r['epoch_time_s'] for r in log]}; eval ms per image "
              f"{[{k: round(r[k], 4) for k in ('pre_ms', 'infer_ms', 'post_ms')} for r in log]}; "
              f"greedy_nms launches per eval {evals}; checkpoints {saved}")
        print(f"  train log: {json.dumps(log)}")
        if len(log) != TRAINER_EPOCHS or min(evals, default=0) < 1 or len(evals) != TRAINER_EPOCHS:
            raise AssertionError(f"Trainer: {len(log)} log records, NMS launches per eval {evals}")
        if "final_ckpt.msgpack" not in saved or not all(
                np.isfinite(v) for r in log for k, v in r.items() if k.startswith("train/")):
            raise AssertionError(f"Trainer: checkpoints {saved}, log {log}")

        # the checkpoint reloads as the trained EMA, fused; its detections on
        # the card equal the plain CPU NMS's on the card's decode
        reloaded = load_inference_variables(os.path.join(wdir, "final_ckpt.msgpack"))
        fused = fuse_state_dict({k: v.cpu() for k, v in trainer.state.ema_state_dict().items()})
        if set(reloaded) != set(fused) or any(not torch.equal(reloaded[k], fused[k]) for k in fused):
            raise AssertionError("final_ckpt.msgpack does not reload as the trained EMA, fused")
        deploy = Model(cfg, deploy=True)
        load_state_dict_strict(deploy, reloaded)
        deploy = deploy.to(dev, torch.bfloat16).to(memory_format=torch.channels_last).eval()
        ev2 = Evaler({}, batch_size=BATCH, img_size=IMG, conf_thres=0.0, device=dev)
        metric, launches, preds, _, _ = eval_on_card(
            ev2, ev2.make_infer_fn(deploy), deploy,
            loader_batches(ev_imgs, ev_labels, ev_masks, BATCH), ("greedy_nms",))
        print(f"final_ckpt.msgpack reloaded through load_inference_variables == the trained EMA "
              f"fused ({len(reloaded)} tensors); eval on the card: launches {launches}, "
              f"detections {sum(map(len, preds))}, == the plain CPU NMS on the card's decode; "
              f"metric {json.dumps(metric)}")
        if launches["greedy_nms"] < 1 or sum(map(len, preds)) == 0:
            raise AssertionError(f"reloaded eval: launches {launches}, {sum(map(len, preds))} dets")
        out["trainer"] = dict(seconds=train_s, log=log, nms_launches_per_eval=evals,
                              checkpoints=saved, reload_launches=launches, metric=metric)
    results["training"] = out
    return out


# ---------------- phases 15-18: the model zoo, RepOpt, distillation ----------------

# phase 15's models at published width and depth: every backbone, every neck
# a config reaches, every training mode, the DFL head and the 4-level head
ZOO = ("yolov6m", "yolov6l", "yolov6s6", "yolov6l6", "base/yolov6s_base", "repopt/yolov6s_hs",
       "repopt/yolov6s_opt")
ZOO_INT8_DOTS_BATCH = 8
ZOO_TRAIN_BATCH = 16
REPOPT_STEPS, REPOPT_HS_BATCH = 3, 8
# phase 18: the KD terms of one batch, card vs CPU in fp32
KD_RTOL = 1e-3
SENS_IMG, SENS_IMAGES = 320, 32


def zoo_model(cfg, seed):
    """The train graph of `cfg` (a config or a built-in name) on the CPU,
    every parameter and BN statistic drawn from `seed`."""
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.utils.config import Config

    cfg = Config.named(cfg) if isinstance(cfg, str) else cfg
    train = build_model(cfg, seed=seed, device="cpu")
    randomize_parameters(train, torch.Generator().manual_seed(seed))
    return cfg, train


def full_k_gate(pred):
    """The conf gate that 2K anchors of every image pass (the NMS kernel
    walks a full K)."""
    from yololp_tpu_torch.ops.nms import select_candidates

    anchors = pred.shape[1]
    _, score_all, _ = select_candidates(pred, 0.0, anchors)
    return float(score_all[:, min(2 * TOPK, anchors) - 1].min())


def check_nms_on_decode(pred, kw, what):
    """The card's NMS on the card's decode equals the plain CPU NMS on it."""
    from yololp_tpu_torch.ops.nms import non_max_suppression

    card_out = non_max_suppression(pred, **kw)
    cpu_out = non_max_suppression(pred.cpu(), **kw)
    for name, a, b in zip(("det", "valid", "num"), card_out, cpu_out):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{what}: card NMS != plain CPU NMS on the card's decode ({name})")
    return cpu_out


def phase_zoo(results, card, dev, batch):
    """15. Deploy inference of the zoo at published width and depth."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.layers.fuse import fuse_model

    out = {}
    for i, name in enumerate(ZOO):
        t0 = time.perf_counter()
        cfg, train = zoo_model(name, SEED + 150 + i)
        weights = fuse_model(train).state_dict()
        n_params = sum(p.numel() for p in train.parameters())
        del train
        inferer = Inferer(".", weights, cfg, img_size=IMG, half=True, iou_thres=0.45,
                          max_det=1000, device=dev)
        strides = (8, 16, 32) if cfg["model"]["head"]["num_layers"] == 3 else (8, 16, 32, 64)
        anchors = sum((IMG // s) ** 2 for s in strides)
        pred = inferer.predict(batch)
        if pred.shape != (BATCH, anchors, 290) or not torch.isfinite(pred).all():
            raise AssertionError(f"{name}: decode {tuple(pred.shape)}, finite "
                                 f"{bool(torch.isfinite(pred).all())}")
        inferer.conf_thres = full_k_gate(pred)
        inferer.warmup()
        (det, valid, num), (launches,) = counted(lambda: inferer._run(batch), "greedy_nms")
        if launches < 1 or int(num.min()) < 1:
            raise AssertionError(f"{name}: greedy_nms launches {launches}, kept {int(num.min())}")
        ms = cuda_ms(lambda: inferer._run(batch), 2)
        img_s = BATCH * 1e3 / float(np.median(ms))
        kw = dict(conf_thres=inferer.conf_thres, iou_thres=0.45, max_det=1000)
        kept = check_nms_on_decode(pred, kw, name)[2]
        # fp32 (TF32 off) at batch 2: the card against the port on the CPU
        inf32 = Inferer(".", weights, cfg, img_size=IMG, half=False, device=dev)
        cpu32 = Inferer(".", weights, cfg, img_size=IMG, half=False, device="cpu")
        p_card, p_cpu = inf32.predict(batch[:2]).cpu(), cpu32.predict(batch[:2])
        err_px = float((p_card[..., :13] - p_cpu[..., :13]).abs().max())
        err_score = float((p_card[..., 13:] - p_cpu[..., 13:]).abs().max())
        ok = (torch.allclose(p_card[..., :13], p_cpu[..., :13], rtol=FP32_RTOL, atol=FP32_ATOL_PX)
              and torch.allclose(p_card[..., 13:], p_cpu[..., 13:], rtol=0, atol=FP32_ATOL_SCORE))
        print(f"[{card}] zoo {name} ({cfg['model']['backbone']['type']} + "
              f"{cfg['model']['neck']['type']}, {len(strides)} levels, "
              f"{cfg.get('training_mode', 'repvgg')}, dfl {bool(cfg['model']['head']['use_dfl'])}; "
              f"{n_params / 1e6:.1f} M parameters in the train graph), fused, bf16 {IMG}px batch "
              f"{BATCH}: {img_s:.1f} img/s ({np.median(ms):.3f} ms a batch, CUDA events); "
              f"greedy_nms launches {launches}; card NMS == plain CPU NMS, kept "
              f"{int(kept.min())}..{int(kept.max())}; fp32 batch 2 card (TF32 off) vs CPU "
              f"{err_px:.3g} px, {err_score:.3g} score ({time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError(f"{name}: fp32 decode card vs CPU {err_px} px, {err_score} score "
                                 f"beyond rtol {FP32_RTOL} + {FP32_ATOL_PX} px / {FP32_ATOL_SCORE}")
        out[name] = dict(img_s=img_s, median_ms=float(np.median(ms)), runs_ms=ms,
                         nms_launches=launches, fp32_err_px=err_px, fp32_err_score=err_score,
                         params=n_params, anchors=anchors)
        if name == "yolov6m":  # beside phase 15b's int8 profile of the same model
            out[name]["profile"] = profile_batch(lambda: inferer._run(batch), card,
                                                 label="yolov6m bf16")
        del inferer, inf32, cpu32, pred, p_card
        torch.cuda.empty_cache()
    results["zoo"] = out
    return out


def phase_zoo_int8(results, card, dev, batch):
    """15b. yolov6m under --int8 (pallas, conv and dots plans) and the
    conv_silu yolov6l's plan."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.layers.fuse import fuse_model
    from yololp_tpu_torch.quant import int8_infer
    from yololp_tpu_torch.quant.quantize import calibrate

    cfg, train = zoo_model("yolov6m", SEED + 151)
    weights = fuse_model(train).state_dict()
    del train
    inf = Inferer(".", weights, cfg, img_size=IMG, half=True, iou_thres=0.45, max_det=1000,
                  device=dev)
    batch2 = np.ascontiguousarray(batch[::-1, :, ::-1])  # a second batch: the frames mirrored
    t0 = time.perf_counter()
    amax = calibrate(inf.model, [batch, batch2], method="max", device=dev)
    kw = dict(iou_thres=0.45, max_det=1000, device=dev)
    conf = full_k_gate(int8_infer.make_int8_infer_fn(inf.model, inf.variables, amax, with_nms=False,
                                                     conv_impl="pallas", **kw)(batch))
    run = int8_infer.make_int8_infer_fn(inf.model, inf.variables, amax, conf_thres=conf,
                                        conv_impl="pallas", **kw)
    mods = [m for m in run.int8_model.modules()
            if isinstance(m, (int8_infer.Int8Conv2d, int8_infer.Int8RepBlock))]
    n_links = sum(len(m.plan[1]) if isinstance(m, int8_infer.Int8RepBlock) else 1 for m in mods)
    run(batch)
    log = LaunchLog(run.int8_model, int8_infer)
    (det, valid, num), (launches, nms_launches) = counted(lambda: run(batch), "int8_conv",
                                                          "greedy_nms")
    log.remove()
    if launches != n_links or launches != len(log.launches) or nms_launches != 1:
        raise AssertionError(f"yolov6m int8 pallas: int8_conv launches {launches}, the plan's "
                             f"calibrated convs {n_links}, recorded {len(log.launches)}; "
                             f"greedy_nms {nms_launches}")
    chains = sum(isinstance(m, int8_infer.Int8RepBlock) for m in mods)
    ms = cuda_ms(lambda: run(batch), 2)
    img_s = BATCH * 1e3 / float(np.median(ms))
    profile = profile_batch(lambda: run(batch), card, label="yolov6m int8 pallas")
    conv_ms = sum(v for k, v in profile["by_name"].items() if "int8_conv_kernel" in k)
    print(f"[{card}] zoo int8, yolov6m {IMG}px, pallas plan, batch {BATCH}: {len(amax)} conv inputs "
          f"calibrated (max, 2 batches) in {time.perf_counter() - t0:.1f} s; int8_conv launches "
          f"{launches} == the {n_links} calibrated convs the plan runs ({chains} RepBlock chains: a "
          f"BepC3's BottleRep stage runs conv by conv), greedy_nms {nms_launches}; {img_s:.1f} img/s "
          f"({np.median(ms):.3f} ms a batch); kept {int(num.min())}..{int(num.max())}; "
          f"int8_conv kernels {conv_ms:.3f} ms of the profiled batch's {profile['window_ms']:.3f}")

    # module replay: every int8 module of the CPU port, fed the card's input,
    # gives the card's output bit for bit (conv plan, fp32, TF32 off)
    inf32 = Inferer(".", weights, cfg, img_size=IMG, half=False, device=dev)
    cpu32 = Inferer(".", weights, cfg, img_size=IMG, half=False, device="cpu")
    kw32 = dict(with_nms=False, conv_impl="conv")
    f_card = int8_infer.make_int8_infer_fn(inf32.model, inf32.variables, amax, device=dev, **kw32)
    f_cpu = int8_infer.make_int8_infer_fn(cpu32.model, cpu32.variables, amax, device="cpu", **kw32)
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, o, n=n: seen.append((n, a[0], o)))
             for n, m in f_card.int8_model.named_modules()
             if isinstance(m, (int8_infer.Int8Conv2d, int8_infer.Int8RepBlock))]
    f_card(batch[:1])
    for h in hooks:
        h.remove()
    cpu_mods = dict(f_cpu.int8_model.named_modules())
    with torch.inference_mode():
        for n, x_in, y in seen:
            if not torch.equal(cpu_mods[n](x_in.cpu()), y.cpu()):
                raise AssertionError(f"yolov6m int8 module {n}: the CPU port on the card's input "
                                     "!= the card")
    print(f"zoo int8 yolov6m, conv plan fp32: each of the {len(seen)} int8 modules of the CPU port, "
          f"fed the card's own input, gives the card's output bit for bit")
    del inf32, cpu32, f_card, f_cpu, seen

    # the dots plan at batch 8: its matmuls counted, its detections the conv plan's
    small = batch[:ZOO_INT8_DOTS_BATCH]
    plans = {}
    for impl in ("dots", "conv"):
        r = int8_infer.make_int8_infer_fn(inf.model, inf.variables, amax, conf_thres=conf,
                                          conv_impl=impl, **kw)
        r(small)
        outs, counts = counted(lambda: [t.cpu() for t in r(small)], "int8_conv", "mxu_matmul")
        plans[impl] = (outs, *counts)
    dots_counts = plans["dots"][1:]
    for name, a, b in zip(("det", "valid", "num"), plans["dots"][0], plans["conv"][0]):
        if not torch.equal(a, b):
            raise AssertionError(f"yolov6m int8: the dots plan's detections != the conv plan's ({name})")
    if plans["dots"][2] < 1 or plans["conv"][2] != 0:
        raise AssertionError(f"mxu_matmul launches: dots {plans['dots'][2]}, conv {plans['conv'][2]}")
    print(f"zoo int8 yolov6m, batch {ZOO_INT8_DOTS_BATCH}: dots plan mxu_matmul launches "
          f"{plans['dots'][2]} (int8_conv {plans['dots'][1]}), conv plan int8_conv "
          f"{plans['conv'][1]}; detections equal bit for bit")
    del inf, run, plans
    torch.cuda.empty_cache()

    # yolov6l (conv_silu): no handoff from a SiLU producer
    cfg_l, train_l = zoo_model("yolov6l", SEED + 152)
    weights_l = fuse_model(train_l).state_dict()
    del train_l
    inf_l = Inferer(".", weights_l, cfg_l, img_size=IMG, half=True, iou_thres=0.45, max_det=1000,
                    device=dev)
    amax_l = calibrate(inf_l.model, [small], method="max", device=dev)
    run_l = int8_infer.make_int8_infer_fn(inf_l.model, inf_l.variables, amax_l, conf_thres=0.0,
                                          conv_impl="conv", **kw)
    handed = [n for n, m in run_l.int8_model.named_modules()
              if isinstance(m, int8_infer.Int8Conv2d) and m.handoff]
    plan = int8_infer.graph_handoffs(amax_l, {p: None for p in amax_l}, relu_acts=False)
    if not all("Bifusion" in n and n.endswith(".cv2.conv") for n in handed) or len(handed) != len(plan):
        raise AssertionError(f"yolov6l (conv_silu) handoffs: {handed}")
    out_l, (l_launches,) = counted(lambda: run_l(small), "int8_conv")
    if not torch.isfinite(out_l[0]).all() or l_launches < 1:
        raise AssertionError("yolov6l int8: non-finite detections or no int8_conv launch")
    print(f"zoo int8 yolov6l (conv_silu), conv plan, batch {ZOO_INT8_DOTS_BATCH}: int8_conv launches "
          f"{l_launches}; handoffs only from ReLU producers: {len(handed)} "
          f"(the BiFusion cv2 -> downsample seams), none from a SiLU conv")
    results["zoo_int8"] = dict(launches=launches, planned=n_links, chains=chains,
                               nms_launches=nms_launches, img_s=img_s, runs_ms=ms,
                               profile=profile, kernel_profile_ms=conv_ms,
                               dots_launches=dict(int8_conv=dots_counts[0],
                                                  mxu_matmul=dots_counts[1]),
                               yolov6l_handoffs=len(handed))
    del inf_l, run_l
    torch.cuda.empty_cache()


def solver_cfg_for(cfg):
    """Phase 14's solver for `cfg`: its own, warmup_bias_lr 0.01, 10 epochs
    of 100 steps."""
    from yololp_tpu_torch.solver.build import SolverConfig

    sol = cfg["solver"]
    return SolverConfig(lr0=sol["lr0"], lrf=sol["lrf"], momentum=sol["momentum"],
                        weight_decay=sol["weight_decay"], warmup_epochs=sol["warmup_epochs"],
                        warmup_momentum=sol["warmup_momentum"], warmup_bias_lr=0.01,
                        lr_scheduler=sol["lr_scheduler"], epochs=10, steps_per_epoch=100)


def loss_cfg_for(cfg):
    """Phase 13's loss for `cfg`: its head, ATSS, at IMG."""
    from yololp_tpu_torch.losses.loss import LossConfig

    head = cfg["model"]["head"]
    return LossConfig(img_size=(IMG, IMG), strides=tuple(head["strides"]),
                      use_dfl=bool(head["use_dfl"]), reg_max=int(head["reg_max"]),
                      iou_type=head["iou_type"], assigner="atss")


def one_state_parity(model, lcfg, scfg, imgs, labels, masks, what, grad_masks):
    """One masked optimizer step at batch 2 in fp32 (TF32 off) on the card
    and on the CPU from one state: (loss rel diff, worst update / bound)."""
    import copy

    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = TRAIN_PARITY_BATCH
    states, items = [], []
    for d in (torch.device(DEVICE), torch.device("cpu")):
        m = copy.deepcopy(model).to(d)
        st = init_train_state(m)
        start = {w: state_numpy(st, w) for w in ("params", "momentum")}
        st, total, it = make_train_step(
            m, lcfg, scfg, batch_size=n, grad_masks={k: v.to(d) for k, v in grad_masks.items()})(
            st, imgs[:n], labels[:n], masks[:n])
        states.append(st)
        items.append(torch.cat([total.reshape(1), it]).cpu().numpy())
    err = float(np.max(np.abs(items[0] - items[1]) / np.maximum(np.abs(items[1]), 1e-12)))
    worst = max(update_errors(state_numpy(states[0], w), state_numpy(states[1], w), start[w])
                for w in ("params", "momentum"))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"{what}: one step from one state, fp32 (TF32 off) batch {n}, card vs CPU: [total + 7 "
          f"items] {json.dumps(np.round(items[1], 6).tolist())}, max rel diff {err:.3g}; worst "
          f"update / bound {worst[0]:.3g} ({worst[1]})")
    if err > TRAIN_LOSS_RTOL or worst[0] > 1.0:
        raise AssertionError(f"{what}: beyond rtol {TRAIN_LOSS_RTOL} (loss) / the update bound")
    return err, worst


def timed_steps(step, state, imgs, labels, masks, n, reps):
    """ms per call of the train step at batch `n`, by CUDA events (after
    one warm-up step)."""
    step(state, imgs[:n], labels[:n], masks[:n])
    times = []
    for i in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        _, total, _ = step(state, imgs[:n], labels[:n], masks[:n])
        e1.record()
        e1.synchronize()
        if not torch.isfinite(total):
            raise AssertionError("non-finite loss in a timed step")
        times.append(e0.elapsed_time(e1))
    return times


def phase_repopt(results, card, dev, eval_frames):
    """17. RepOpt: 2 hyper-search steps of yolov6s_hs, its scales saved and
    loaded, yolov6s_opt re-initialized from them and trained with masks;
    then the Trainer's RepOpt path for an epoch of 2 steps."""
    import copy
    import tempfile
    import types

    from yololp_tpu_torch.core.engine import Trainer
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
    from yololp_tpu_torch.solver.repopt import (extract_scales, gradient_masks, load_scales,
                                                reinitialize, save_scales)
    from yololp_tpu_torch.utils.config import Config

    out = {}
    imgs, labels, masks = labelled_frames(np.random.default_rng(SEED + 17), 2 * BATCH, IMG)
    hs_cfg, hs = zoo_model("repopt/yolov6s_hs", SEED + 170)
    hs = hs.to(dev).to(memory_format=torch.channels_last)
    st = init_train_state(hs)
    step = make_train_step(hs, loss_cfg_for(hs_cfg), solver_cfg_for(hs_cfg),
                           batch_size=REPOPT_HS_BATCH, dtype=torch.bfloat16)
    for i in range(2):
        sl = slice(i * REPOPT_HS_BATCH, (i + 1) * REPOPT_HS_BATCH)
        st, total, _ = step(st, imgs[sl], labels[sl], masks[sl])
        if not torch.isfinite(total):
            raise AssertionError("non-finite hyper-search loss")
    scales = extract_scales(hs.state_dict())
    del hs, st, step
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "yolov6s_scales.msgpack")
        save_scales(scales, path)
        loaded = load_scales(path)
        if len(loaded) != len(scales) or not all(
                np.array_equal(a, b) for x, y in zip(loaded, scales) for a, b in zip(x, y)):
            raise AssertionError("scales written and read back differ")
        opt_cfg = Config.named("repopt/yolov6s_opt")
        opt_cfg["scales"] = path
        _, opt = zoo_model(opt_cfg, SEED + 171)
        params = dict(opt.named_parameters())
        new = reinitialize(params, loaded, generator=torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            for k, v in new.items():
                params[k].copy_(v)
        grad_masks = gradient_masks(params, loaded)
        print(f"RepOpt: yolov6s_hs 2 steps (batch {REPOPT_HS_BATCH}, bf16) -> {len(scales)} scale "
              f"tuples ({sum(len(x) == 3 for x in scales)} with identity), saved and loaded; "
              f"yolov6s_opt: {len(new)} RealVGG kernels re-initialized, {len(grad_masks)} masks")
        lcfg, scfg = loss_cfg_for(opt_cfg), solver_cfg_for(opt_cfg)
        out["parity"] = one_state_parity(opt, lcfg, scfg, imgs, labels, masks,
                                         "RepOpt yolov6s_opt masked step", grad_masks)
        model = copy.deepcopy(opt).to(dev).to(memory_format=torch.channels_last)
        st = init_train_state(model)
        step = make_train_step(model, lcfg, scfg, batch_size=BATCH, dtype=torch.bfloat16,
                               grad_masks={k: v.to(dev) for k, v in grad_masks.items()})
        ms = timed_steps(step, st, imgs, labels, masks, BATCH, REPOPT_STEPS)
        print(f"[{card}] RepOpt masked train step, yolov6s_opt {IMG}px batch {BATCH}, autocast bf16: "
              f"{float(np.median(ms)):.3f} ms per step (median of {REPOPT_STEPS}, CUDA events), "
              f"{BATCH * 1e3 / float(np.median(ms)):.1f} img/s")
        out.update(step_ms=float(np.median(ms)), steps_ms=ms)
        del model, st, step
        torch.cuda.empty_cache()

        # the Trainer's RepOpt path: 1 epoch of 2 steps over memo frames
        img_dir = write_memo_dataset(os.path.join(tmp, "data"), imgs, labels, masks)
        tcfg = copy.deepcopy(opt_cfg)
        tcfg["data_aug"] = {k: 0.0 for k in opt_cfg["data_aug"]}
        args = types.SimpleNamespace(
            img_size=IMG, batch_size=BATCH, epochs=1, workers=0,
            save_dir=os.path.join(tmp, "run"), seed=SEED, bf16=True, cache_device=True,
            assigner=None, stop_aug_last_n_epoch=15, eval_interval=1, heavy_eval_range=50,
            quant=False, calib=False, distill=False, device=dev, epochs_per_dispatch=1)
        t0 = time.perf_counter()
        trainer = Trainer(args, tcfg, {"train": img_dir, "val": img_dir})
        ev_imgs, ev_labels, ev_masks = (a[:BATCH] for a in eval_frames)
        ev = Evaler({}, batch_size=BATCH, img_size=IMG, conf_thres=0.0, device=dev)
        eval_model = trainer._deploy_model()
        trainer._eval_cache = (eval_model, ev, loader_batches(ev_imgs, ev_labels, ev_masks, BATCH),
                               ev.make_infer_fn(eval_model))
        _, (nms_n,) = counted(trainer.train, "greedy_nms")
        log = [json.loads(line) for line in open(trainer.log_path)]
        print(f"[{card}] Trainer, repopt/yolov6s_opt with a scales file, {IMG}px batch {BATCH}, 1 "
              f"epoch of {trainer.steps_per_epoch} steps: {time.perf_counter() - t0:.1f} s; weight "
              f"decay {trainer.solver_cfg.weight_decay:g}; greedy_nms launches in its eval "
              f"{nms_n}; log {json.dumps(log)}")
        if len(log) != 1 or nms_n < 1 or not all(
                np.isfinite(v) for k, v in log[0].items() if k.startswith("train/")):
            raise AssertionError(f"RepOpt Trainer: log {log}, NMS launches {nms_n}")
        out["trainer"] = dict(log=log, nms_launches=nms_n)
    results["repopt"] = out
    return out


def phase_distill(results, card, dev):
    """18. Distillation of yololpn from a yololps teacher checkpoint written
    by the port, then tools.sensitivity's analysis on yololpn at 320 px."""
    import tempfile

    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
    from yololp_tpu_torch.layers.fuse import fuse_model
    from yololp_tpu_torch.losses.distill import distill_loss
    from yololp_tpu_torch.losses.loss import compute_loss
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.ops.division import unit_pixels
    from yololp_tpu_torch.quant.quantize import calibrate
    from yololp_tpu_torch.tools import sensitivity
    from yololp_tpu_torch.utils.checkpoint import load_checkpoint_raw, save_checkpoint
    from yololp_tpu_torch.utils.convert import (jax_to_state_dict, load_state_dict_strict,
                                                state_dict_to_jax)

    out = {}
    imgs, labels, masks = labelled_frames(np.random.default_rng(SEED + 18), BATCH, IMG)
    s_cfg, student = zoo_model("yololpn", SEED + 180)
    t_cfg, t_train = zoo_model("yololps", SEED + 181)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "teacher.msgpack")
        save_checkpoint({"format": "train", "variables": state_dict_to_jax(t_train.state_dict())},
                        path)
        teacher = Model(t_cfg)
        load_state_dict_strict(teacher, jax_to_state_dict(load_checkpoint_raw(path)["variables"]))
    del t_train
    lcfg, scfg = loss_cfg_for(s_cfg), solver_cfg_for(s_cfg)
    dcfg = dict(s_cfg["model"]["head"].get("distill_weight") or {})

    # the KD terms of one batch of 2 in fp32 (TF32 off), card vs CPU, on the
    # CPU's fg mask
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = TRAIN_PARITY_BATCH
    terms, fg = [], None
    for d in ("cpu", dev):
        x = unit_pixels(torch.from_numpy(imgs[:n]).to(d).permute(0, 3, 1, 2),
                        torch.float32).contiguous()
        with torch.no_grad():
            s_out = student.to(d).train()(x)
            t_out = teacher.to(d).train()(x)
            if fg is None:
                fg = compute_loss(s_out, torch.from_numpy(labels[:n]), torch.from_numpy(masks[:n]),
                                  lcfg, with_fg=True)[2]
            kd = distill_loss(s_out, t_out, fg.to(d), temperature=float(dcfg.get("temperature", 20.0)),
                              use_dfl=lcfg.use_dfl, reg_max=lcfg.reg_max)
        terms.append([float(t) for t in kd])
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    kd_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(terms[1], terms[0]))
    print(f"distill yololpn <- yololps (teacher checkpoint written by the port), fp32 batch {n}, "
          f"{int(fg.sum())} fg anchors: KD terms (cls, dfl) CPU {terms[0]}, card {terms[1]}, max "
          f"rel diff {kd_err:.3g}")
    if not (terms[0][0] > 0 and kd_err <= KD_RTOL):
        raise AssertionError(f"distill KD terms card vs CPU beyond rtol {KD_RTOL}: {terms}")

    # the distillation train step at batch 32, bf16
    student = student.to(dev).to(memory_format=torch.channels_last)
    teacher = teacher.to(dev).to(memory_format=torch.channels_last)
    st = init_train_state(student)
    step = make_train_step(student, lcfg, scfg, batch_size=BATCH, teacher=teacher, distill_cfg=dcfg,
                           dtype=torch.bfloat16)
    ms = timed_steps(step, st, imgs, labels, masks, BATCH, REPOPT_STEPS)
    print(f"[{card}] distillation train step (yololpn student, yololps teacher forward), {IMG}px "
          f"batch {BATCH}, autocast bf16: {float(np.median(ms)):.3f} ms per step (median of "
          f"{REPOPT_STEPS}, CUDA events), {BATCH * 1e3 / float(np.median(ms)):.1f} img/s")
    out.update(kd_terms=dict(cpu=terms[0], card=terms[1], rel_err=kd_err),
               step_ms=float(np.median(ms)), steps_ms=ms)
    del st, step, teacher

    # tools.sensitivity's analysis on yololpn at 320 px, 32 frames in memory
    # (the card's machine has no cv2 for the CLI's JPEG loader)
    t0 = time.perf_counter()
    student.eval()
    weights = fuse_model(student.cpu()).state_dict()
    inf = Inferer(".", weights, s_cfg, img_size=SENS_IMG, half=True, device=dev)
    s_imgs, s_labels, s_masks = labelled_frames(np.random.default_rng(SEED + 181), SENS_IMAGES,
                                                SENS_IMG)
    amax = calibrate(inf.model, [s_imgs], method="max", device=dev)
    ev = Evaler({}, batch_size=BATCH, img_size=SENS_IMG, conf_thres=0.0, device=dev)
    # the frames labelled with the float model's own detections, so that the
    # baseline is above 0 and a quantized conv can move it
    preds, _ = ev.predict(ev.make_infer_fn(inf.model),
                          loader_batches(s_imgs, s_labels, s_masks, BATCH))
    s_labels, s_masks = self_labels(preds, SENS_IMG, s_labels.shape[1])
    base, full, ranked = sensitivity.analyse(inf.model, amax, ev,
                                             loader_batches(s_imgs, s_labels, s_masks, BATCH))
    if len(ranked) != len(amax) or not np.isfinite([base, full] + [v for _, v in ranked]).all():
        raise AssertionError(f"sensitivity: {len(ranked)} of {len(amax)} convs ranked")
    if not (base > 0 and any(v != 0 for _, v in ranked)):
        raise AssertionError(f"sensitivity: baseline mAP {base}, every drop 0: nothing measured")
    print(f"[{card}] tools.sensitivity analysis, yololpn {SENS_IMG}px, {SENS_IMAGES} frames: "
          f"{len(ranked)} convs one at a time in {time.perf_counter() - t0:.1f} s; baseline mAP "
          f"{base:.4f}, fully quantized {full:.4f}; top drops "
          f"{json.dumps([(k, round(v, 4)) for k, v in ranked[:3]])}")
    out["sensitivity"] = dict(baseline=base, full=full, seconds=time.perf_counter() - t0,
                              n=len(ranked))
    results["distill"] = out
    return out


# ---------------- phases 19-20: multi-GPU (sharded inference, data-parallel training) ----------------

DDP_PARITY_BATCH, DDP_TIME_BATCH = 4, 32  # global batches (2 and 16 a rank)
DDP_GROUP_TIMEOUT_S = 120  # a rank's collectives
DDP_RUN_TIMEOUT_S = 420  # one multi-rank run, start to end
BN_STATS_RTOL = 1e-4  # phase 20: BN running statistics, 2 ranks vs one process
# phase 19: a replica's bf16 decode of its chunk of 16 against the plain
# model's decode of the same chunk on cuda:0, where the replica runs on
# another card (on cuda:0 itself they must be equal bit for bit). The
# decode of the whole batch of 32 is not comparable to a bound: cuDNN runs
# other kernels at batch 32, and bf16 rounds each differently (measured on
# the H100: up to 4.0 px and 0.0234 score apart)
SHARD_RTOL, SHARD_ATOL_PX, SHARD_ATOL_SCORE = 2e-2, 1.0, 2e-2


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def hooked_decodes(replicas):
    """Forward hooks keeping every replica's decode; returns (decodes, hooks)."""
    decodes = []
    hooks = [r.register_forward_hook(lambda m, a, out: decodes.append(out.detach()))
             for r in replicas]
    return decodes, hooks


def phase_sharded(results, card, dev, inferer, batch):
    """19. Sharded inference and eval (parallel/infer.py): yololps bf16 at
    batch 32 split over a mesh of 2 cards, or of 2 replicas on cuda:0 when
    there is one card."""
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.ops.nms import non_max_suppression
    from yololp_tpu_torch.parallel.infer import make_sharded_infer_fn

    two = torch.cuda.device_count() >= 2
    mesh = [torch.device("cuda", 0), torch.device("cuda", 1 if two else 0)]
    what = "2 cards" if two else "2 replicas on cuda:0 (one card: a plumbing check)"
    kw = dict(conf_thres=inferer.conf_thres, iou_thres=inferer.iou_thres, max_det=inferer.max_det)
    run, put = make_sharded_infer_fn(inferer.model, mesh, pre_nms_topk=TOPK, **kw)
    staged = put(batch)
    run(staged)  # warm-up
    sync_all()
    decodes, hooks = hooked_decodes(run.replicas)
    try:
        (det, valid, num), (launches,) = counted(lambda: run(staged), "greedy_nms")
    finally:
        for h in hooks:
            h.remove()
    if launches != len(mesh):
        raise AssertionError(f"sharded inference: {launches} greedy_nms launches for a mesh of "
                             f"{len(mesh)} and one batch")
    pred = torch.cat([d.float().cpu() for d in decodes])
    cpu = non_max_suppression(pred, pre_nms_topk=TOPK, **kw)
    for name, a, b in zip(("det", "valid", "num"), (det, valid, num), cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"sharded inference != plain CPU NMS on its own decode ({name})")
    # the single-device decode of each replica's chunk (the same batch size)
    chunks = np.split(batch, len(mesh))
    single = torch.cat([inferer.predict(c).cpu() for c in chunks])
    n = len(chunks[0])
    for i, d in enumerate(mesh):
        got, want = pred[i * n:(i + 1) * n], single[i * n:(i + 1) * n]
        if d == dev and not torch.equal(got, want):
            raise AssertionError(f"replica {i} on {d}: its decode != the plain model's on {d}")
        if not (torch.allclose(got[..., :13], want[..., :13], rtol=SHARD_RTOL, atol=SHARD_ATOL_PX)
                and torch.allclose(got[..., 13:], want[..., 13:], rtol=0,
                                   atol=SHARD_ATOL_SCORE)):
            raise AssertionError(f"replica {i} on {d}: decode beyond the bf16 tolerance")
    err_px = float((pred[..., :13] - single[..., :13]).abs().max())
    err_score = float((pred[..., 13:] - single[..., 13:]).abs().max())
    whole = inferer.predict(batch).cpu()
    whole_px = float((pred[..., :13] - whole[..., :13]).abs().max())
    whole_score = float((pred[..., 13:] - whole[..., 13:]).abs().max())
    ms_sharded = float(np.median(cuda_ms(lambda: run(staged), 2)))
    ms_single = float(np.median(cuda_ms(lambda: inferer._run(batch), 2)))
    print(f"[{card}] sharded inference, yololps {IMG}px bf16, batch {BATCH} over {what}: "
          f"greedy_nms launches {launches} (one a card a batch); det/valid/num == plain CPU NMS "
          f"on the sharded decode; decode vs the single-device decode of the same chunks max "
          f"|diff| {err_px:.4g} px, {err_score:.4g} score (bit-equal: "
          f"{torch.equal(pred, single)}; off cuda:0 the tolerance is rtol {SHARD_RTOL} + "
          f"{SHARD_ATOL_PX} px, {SHARD_ATOL_SCORE} score); vs the single-device decode of the "
          f"whole batch {whole_px:.4g} px, {whole_score:.4g} score (other kernels at batch "
          f"{BATCH}); {ms_sharded:.3f} ms a batch sharded, {ms_single:.3f} single-device (CUDA "
          f"events on cuda:0)")

    # Evaler.predict and eval with the mesh on phase 12's frames
    imgs, labels, masks = labelled_frames(np.random.default_rng(SEED + 12), EVAL_FRAMES, IMG)
    loader = loader_batches(imgs, labels, masks, BATCH)
    ev = Evaler({}, batch_size=BATCH, img_size=IMG, conf_thres=inferer.conf_thres, device=dev)
    preds1, targets1 = ev.predict(ev.make_infer_fn(inferer.model), loader)
    metric1 = ev.eval(preds1, targets1)
    mesh_fn = ev.make_infer_fn(inferer.model, mesh=mesh)
    decodes, hooks = hooked_decodes(mesh_fn.replicas)
    try:
        (preds2, targets2), (eval_launches,) = counted(lambda: ev.predict(mesh_fn, loader),
                                                       "greedy_nms")
    finally:
        for h in hooks:
            h.remove()
    if eval_launches != len(mesh) * len(loader):
        raise AssertionError(f"mesh eval: {eval_launches} launches for {len(loader)} batches")
    cpu_preds = []
    for i, (b_imgs, *_) in enumerate(loader):
        p = torch.cat([d.float().cpu() for d in decodes[i * len(mesh):(i + 1) * len(mesh)]])
        d_, v_, n_ = non_max_suppression(p, conf_thres=ev.conf_thres, iou_thres=ev.iou_thres,
                                         max_det=ev.max_det)
        cpu_preds += [d_[j][v_[j]][: int(n_[j])].numpy() for j in range(len(b_imgs))]
    if len(preds2) != EVAL_FRAMES or any(not np.array_equal(a, b) for a, b in zip(preds2, cpu_preds)):
        raise AssertionError("mesh eval detections != plain CPU NMS on the sharded decode")
    metric2 = ev.eval(preds2, targets2)
    if metric2 != metric1 or any(not np.array_equal(a, b) for a, b in zip(targets1, targets2)):
        raise AssertionError(f"mesh eval metric {metric2} != single-device {metric1}")
    own = own_gts(preds1)
    own1, own2 = ev.eval(preds1, own), ev.eval(preds2, own)
    print(f"[{card}] Evaler.predict + eval with mesh= ({what}), {EVAL_FRAMES} frames in batches of "
          f"{BATCH}: greedy_nms launches {eval_launches}; detections == plain CPU NMS on the "
          f"sharded decode; metric == single-device {json.dumps(metric1)}; with the "
          f"single-device detections as gts: sharded {json.dumps(own2[:5])}, single-device "
          f"{json.dumps(own1[:5])}; eval_speed {json.dumps(ev.eval_speed())}")
    results["sharded"] = dict(mesh=[str(d) for d in mesh], launches=launches,
                              decode_err_px=err_px, decode_err_score=err_score,
                              bit_equal=bool(torch.equal(pred, single)),
                              whole_batch_err_px=whole_px, whole_batch_err_score=whole_score,
                              ms_sharded=ms_sharded,
                              ms_single=ms_single, eval_launches=eval_launches, metric=metric2,
                              metric_own_gts=dict(sharded=own2, single=own1))


def multi_rank_plan():
    """(world, backend, card of each rank, what it is)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return 2, "nccl", [0, 1], f"NCCL, one rank per card (2 of {n} cards)"
    return 2, "gloo", [0, 0], ("gloo, 2 ranks sharing cuda:0 (one card, and NCCL refuses two ranks "
                               "on one card: a plumbing check of the collectives, not a scaling "
                               "number)")


def ddp_rank(r, world, backend, devs, port, inp_path, out_path, tasks):
    """One rank of phase 20 (spawned): joins the group, runs `tasks` from the
    inputs the parent saved, saves what the parent checks."""
    import copy
    import datetime
    import types

    import torch.distributed as dist

    from yololp_tpu_torch.core.engine import Trainer
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
    from yololp_tpu_torch.layers.fuse import fuse_state_dict
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.ops import _build
    from yololp_tpu_torch.utils.checkpoint import load_inference_variables
    from yololp_tpu_torch.utils.convert import load_state_dict_strict

    dev = torch.device("cuda", devs[r])
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=r, timeout=datetime.timedelta(seconds=DDP_GROUP_TIMEOUT_S))
    inp = torch.load(inp_path, weights_only=False)
    cfg, lcfg, scfg = inp["cfg"], inp["lcfg"], inp["scfg"]
    out = {}

    def model_on_card():
        m = Model(cfg).to(dev)
        load_state_dict_strict(m, inp["state_dict"])
        return m

    if "parity" in tasks:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        hb = DDP_PARITY_BATCH // world
        imgs, labels, masks = (a[r * hb:(r + 1) * hb] for a in inp["parity"])
        out["parity"] = ddp_parity_step(model_on_card(), lcfg, scfg, imgs, labels, masks)
    if "time" in tasks:
        model = model_on_card().to(memory_format=torch.channels_last)
        state = init_train_state(model)
        step = make_train_step(model, lcfg, scfg, batch_size=DDP_TIME_BATCH, dtype=torch.bfloat16)
        hb = DDP_TIME_BATCH // world
        imgs, labels, masks = (torch.from_numpy(a[r * hb:(r + 1) * hb]).to(dev)
                               for a in inp["time"])
        for _ in range(2):
            state, total, _ = step(state, imgs, labels, masks)
        torch.cuda.synchronize(dev)
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            state, total, _ = step(state, imgs, labels, masks)
        end.record()
        end.synchronize()
        out["step_ms"] = start.elapsed_time(end) / 3
        out["total"] = float(total)
        del model, state, step
        torch.cuda.empty_cache()
    if "trainer" in tasks:
        tcfg = copy.deepcopy(cfg)
        tcfg["data_aug"] = {k: 0.0 for k in cfg["data_aug"]}
        args = types.SimpleNamespace(
            img_size=IMG, batch_size=BATCH, epochs=1, workers=0,
            save_dir=os.path.join(inp["save_dir"], f"{backend}{world}"),
            conf_file="yololps", seed=SEED, bf16=True, cache_device=True, assigner=None,
            stop_aug_last_n_epoch=15, eval_interval=1, heavy_eval_range=50, quant=False,
            calib=False, distill=False, device=dev, epochs_per_dispatch=1)
        t0 = time.perf_counter()
        trainer = Trainer(args, tcfg, {"train": inp["memo_dir"], "val": inp["memo_dir"]})
        sd = {k: v for k, v in inp["state_dict"].items() if not k.endswith("num_batches_tracked")}
        trainer.state.load(sd, sd, {}, ema_updates=0, step=0, last_opt_step=-1_000_000)
        if r == 0:  # rank 0 evaluates, on phase 12's frames held in memory
            ev = Evaler({}, batch_size=BATCH, img_size=IMG, conf_thres=0.0, device=dev)
            eval_model = trainer._deploy_model()
            trainer._eval_cache = (eval_model, ev, loader_batches(*inp["eval_frames"], BATCH),
                                   ev.make_infer_fn(eval_model))
        nms_n = _build.launches("greedy_nms")
        trainer.train()
        torch.cuda.synchronize(dev)
        ema = trainer.state.ema_state_dict()
        nms_n = _build.launches("greedy_nms") - nms_n
        out["trainer"] = dict(seconds=time.perf_counter() - t0, nms_launches=nms_n,
                              steps=trainer.steps_per_epoch,
                              ema_sum=float(sum(v.double().sum() for v in ema.values())))
        if r == 0:
            wdir = os.path.join(args.save_dir, "weights")
            reloaded = load_inference_variables(os.path.join(wdir, "final_ckpt.msgpack"))
            fused = fuse_state_dict({k: v.cpu() for k, v in ema.items()})
            out["trainer"].update(
                log=[json.loads(line) for line in open(trainer.log_path)],
                checkpoints=sorted(os.listdir(wdir)),
                reload_equal=set(reloaded) == set(fused) and all(
                    torch.equal(reloaded[k], fused[k]) for k in fused))
    torch.save(out, f"{out_path}.{r}.pt")
    if backend == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
    dist.destroy_process_group()


def ddp_parity_step(model, lcfg, scfg, imgs, labels, masks):
    """One fp32 train step of `model` from its state on this process's batch
    (a rank's shard, or the global batch without a group): the fg mask of
    the batch, the loss and the updated state."""
    import copy

    from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
    from yololp_tpu_torch.losses.loss import assign
    from yololp_tpu_torch.ops.division import unit_pixels

    dev = next(model.parameters()).device
    probe = copy.deepcopy(model).train()  # its BN statistics are thrown away
    with torch.no_grad():
        x = unit_pixels(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2), torch.float32)
        fg = assign(probe(x), torch.from_numpy(labels).to(dev), torch.from_numpy(masks).to(dev),
                    lcfg).res.fg_mask.cpu()
    del probe
    state = init_train_state(model)
    start = {w: state_numpy(state, w) for w in ("params", "ema", "momentum")}
    step = make_train_step(model, lcfg, scfg, batch_size=DDP_PARITY_BATCH)
    state, total, items = step(state, imgs, labels, masks)
    return dict(fg=fg, items=torch.cat([total.reshape(1), items]).cpu().numpy(), start=start,
                end={w: state_numpy(state, w) for w in start},
                counts=(state.ema_updates, state.step, state.last_opt_step))


def spawn_ranks(world, backend, devs, inp_path, out_path, tasks):
    """Run ddp_rank on `world` spawned processes; every rank past
    DDP_RUN_TIMEOUT_S is killed and the phase fails."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.start_processes(
        ddp_rank, args=(world, backend, devs, port, inp_path, out_path, tasks), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.time() + DDP_RUN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"phase 20: {world} ranks ({backend}) still running after "
                                 f"{DDP_RUN_TIMEOUT_S} s")
    return [torch.load(f"{out_path}.{r}.pt", weights_only=False) for r in range(world)]


def phase_ddp(results, card, dev, train_model, cfg, eval_frames):
    """20. Data-parallel training: 2 ranks against one process (parity), a
    bf16 step's time, and the Trainer with --cache-device under 2 ranks (and,
    on one card, once under NCCL at world size 1)."""
    import copy
    import tempfile

    from yololp_tpu_torch.losses.loss import LossConfig
    from yololp_tpu_torch.solver.build import SolverConfig

    world, backend, devs, what = multi_rank_plan()
    print(f"[{card}] phase 20 backend: {what}", flush=True)
    head, sol = cfg["model"]["head"], cfg["solver"]
    lcfg = LossConfig(img_size=(IMG, IMG), strides=tuple(head["strides"]),
                      use_dfl=bool(head["use_dfl"]), reg_max=int(head["reg_max"]),
                      iou_type=head["iou_type"], assigner="atss")
    scfg = SolverConfig(lr0=sol["lr0"], lrf=sol["lrf"], momentum=sol["momentum"],
                        weight_decay=sol["weight_decay"], warmup_epochs=sol["warmup_epochs"],
                        warmup_momentum=sol["warmup_momentum"], warmup_bias_lr=0.01,
                        lr_scheduler=sol["lr_scheduler"], epochs=10, steps_per_epoch=100)
    rng = np.random.default_rng(SEED + 20)
    parity = labelled_frames(rng, DDP_PARITY_BATCH, IMG)
    parity[1][DDP_PARITY_BATCH // 2:, :, :8] = -1  # rank 1's shard holds no ground truth
    parity[1][DDP_PARITY_BATCH // 2:, :, 8:] = 0
    parity[2][DDP_PARITY_BATCH // 2:] = 0
    out = {"backend": backend, "world": world, "cards": torch.cuda.device_count(), "what": what}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        inp = {"cfg": cfg, "lcfg": lcfg, "scfg": scfg, "parity": parity,
               "state_dict": {k: v.detach().cpu() for k, v in train_model.state_dict().items()},
               "time": labelled_frames(rng, DDP_TIME_BATCH, IMG), "eval_frames": eval_frames,
               "memo_dir": write_memo_dataset(os.path.join(tmp, "memo"), *eval_frames),
               "save_dir": os.path.join(tmp, "run")}
        inp_path = os.path.join(tmp, "inputs.pt")
        torch.save(inp, inp_path)

        # the single-process reference: one fp32 step on the global batch on the card
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = ddp_parity_step(copy.deepcopy(train_model).to(dev), lcfg, scfg, *parity)

        t0 = time.perf_counter()
        ranks = spawn_ranks(world, backend, devs, inp_path, os.path.join(tmp, "ranks"),
                            ("parity", "time", "trainer"))
        ranks_s = time.perf_counter() - t0
        got = ranks[0]["parity"]
        fg = torch.cat([rk["parity"]["fg"] for rk in ranks])
        if not torch.equal(fg, ref["fg"]):
            raise AssertionError(f"phase 20: fg masks differ in {int((fg != ref['fg']).sum())} "
                                 "anchors between 2 ranks and one process")
        items_err = float(np.max(np.abs(got["items"] - ref["items"])
                                 / np.maximum(np.abs(ref["items"]), 1e-12)))
        worst = {w: update_errors(got["end"][w], ref["end"][w], ref["start"][w])
                 for w in ("params", "ema", "momentum")}
        stats_err = max(float(np.abs(got["end"]["params"][k] - v).max() / np.abs(v).max())
                        for k, v in ref["end"]["params"].items()
                        if k.endswith(("running_mean", "running_var")))
        print(f"[{card}] DDP parity ({backend}, {world} ranks), yololps {IMG}px fp32 (TF32 off), "
              f"global batch {DDP_PARITY_BATCH} ({DDP_PARITY_BATCH // world} a rank, rank 1 without "
              f"ground truth), ATSS, one step from one state vs one process on the global batch: "
              f"fg masks equal ({int(ref['fg'].sum())} fg anchors); [total + 7 items] "
              f"{json.dumps(np.round(ref['items'], 6).tolist())}, max rel diff {items_err:.3g}; "
              f"counts {got['counts']}; worst update / bound: "
              + ", ".join(f"{w} {v:.3g} ({k})" for w, (v, k) in worst.items())
              + f"; BN running statistics max rel diff {stats_err:.3g}")
        if got["counts"] != ref["counts"] or not (
                items_err <= TRAIN_LOSS_RTOL and all(v <= 1.0 for v, _ in worst.values())
                and stats_err <= BN_STATS_RTOL):
            raise AssertionError(f"phase 20 parity: items {items_err}, updates {worst}, BN "
                                 f"statistics {stats_err}, counts {got['counts']} vs {ref['counts']}")
        step_ms = max(rk["step_ms"] for rk in ranks)
        print(f"[{card}] DDP train step, yololps {IMG}px bf16, global batch {DDP_TIME_BATCH} "
              f"({DDP_TIME_BATCH // world} a rank), {what}: {step_ms:.3f} ms a step (CUDA events, "
              f"the slower rank), {DDP_TIME_BATCH * 1e3 / step_ms:.1f} img/s", flush=True)
        trainer_runs = {f"{backend} x{world}": ranks}
        if world == 2 and backend == "gloo":
            # one card: the Trainer once more under NCCL, at world size 1
            trainer_runs["nccl x1"] = spawn_ranks(1, "nccl", [0], inp_path,
                                                  os.path.join(tmp, "nccl1"), ("trainer",))
        for label, rks in trainer_runs.items():
            t0, t1 = rks[0]["trainer"], rks[-1]["trainer"]
            print(f"[{card}] Trainer under {label}: 1 epoch of {t0['steps']} steps (--cache-device, "
                  f"{EVAL_FRAMES} memo frames, global batch {BATCH}), eval on rank 0: "
                  f"{t0['seconds']:.1f} s; greedy_nms launches by rank "
                  f"{[rk['trainer']['nms_launches'] for rk in rks]}; checkpoints {t0['checkpoints']}; "
                  f"final_ckpt reloads as rank 0's EMA fused, bit for bit: {t0['reload_equal']}; "
                  f"EMA sums by rank {[rk['trainer']['ema_sum'] for rk in rks]}")
            print(f"  train log: {json.dumps(t0['log'])}")
            if not (t0["steps"] == 2 and len(t0["log"]) == 1 and t0["reload_equal"]
                    and t0["nms_launches"] >= 1
                    and all(rk["trainer"]["nms_launches"] == 0 for rk in rks[1:])
                    and t1["ema_sum"] == t0["ema_sum"]
                    and "final_ckpt.msgpack" in t0["checkpoints"]):
                raise AssertionError(f"phase 20 Trainer under {label}: "
                                     f"{[rk['trainer'] for rk in rks]}")
        out.update(parity=dict(items=ref["items"].tolist(), items_rel_err=items_err,
                               worst_update={w: list(v) for w, v in worst.items()},
                               bn_stats_rel_err=stats_err),
                   step_ms=step_ms, img_s=DDP_TIME_BATCH * 1e3 / step_ms, ranks_s=ranks_s,
                   trainer={label: [rk["trainer"] for rk in rks]
                            for label, rks in trainer_runs.items()})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20 in {out['seconds']:.0f} s")
    results["ddp"] = out

# phase 21, each AOTInductor package against eager (bf16) or the eager conv
# plan (int8) on the same batch: its decode's boxes and corners (columns
# :13) equal bit for bit (Inductor's epilogues round where the kernel does,
# under emulate_precision_casts; a flipped bf16 rounding or int8 code would
# move them) and its scores within two fp32 ULPs at 1.0: Inductor's fused
# sigmoid rounds in the last bit where eager's does not (found on the card).
# So the detections are eager's up to the order of candidates whose scores
# lie that close (swaps were seen on the card), and valid and num equal
EXPORT_SCORE_ATOL = 2.0 ** -22
RUNNER_ITERS = 20  # the C++ runner's --bench
DISPATCH_CALLS = 200  # host cost of an op dispatch: calls timed


class WithDecode(torch.nn.Module):
    """An end2end export program (yololp_tpu_torch.export's ExportModel)
    that also returns its raw decode, so that its detections can be held
    against the plain CPU NMS on the same program's own decode: (det, valid,
    num, pred). The runner reads `num` as output 2, as from the export."""

    def __init__(self, export_model):
        super().__init__()
        self.m = export_model

    def forward(self, images_u8):
        from yololp_tpu_torch.ops.nms import non_max_suppression

        pred = self.m.decode(images_u8)
        return (*non_max_suppression(pred.float(), **self.m.nms_kw), pred)


def lcg_batch(batch, size):
    """The C++ runner's first staged batch (deploy/aoti_cpp/yololp_runner.cpp,
    the JAX runner's LCG: x = 1664525 x + 1013904223 mod 2**32 from 12345,
    the byte x >> 24) in closed form: x_i = a**i x_0 + c (a**0 + ... +
    a**(i-1)), in uint32 arithmetic that wraps as C++'s unsigned does."""
    n = batch * size * size * 3
    powers = np.cumprod(np.full(n, 1664525, np.uint32), dtype=np.uint32)  # a**1 .. a**n
    geo = np.cumsum(np.concatenate([np.ones(1, np.uint32), powers[:-1]]), dtype=np.uint32)
    x = powers * np.uint32(12345) + geo * np.uint32(1013904223)
    return (x >> np.uint32(24)).astype(np.uint8).reshape(batch, size, size, 3)


def nms_on_own_decode(out, kw, what):
    """(det, valid, num, pred) of a program: det/valid/num equal the plain
    CPU NMS on its own decode, exactly. Returns the kept range."""
    from yololp_tpu_torch.ops.nms import non_max_suppression

    pred = out[3].float().cpu()
    if not torch.isfinite(pred).all():
        raise AssertionError(f"{what}: non-finite decode")
    want = non_max_suppression(pred, **kw)
    for name, a, b in zip(("det", "valid", "num"), out[:3], want):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{what}: {name} != the plain CPU NMS on its own decode")
    return int(want[2].min()), int(want[2].max())


def host_us(fn, calls=DISPATCH_CALLS):
    """Host microseconds a call of `fn` takes to enqueue its work (the card
    is not waited for inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def counted(fn, *kernels):
    """(fn()'s output, each named kernel's launches during the call): the
    counts (ops/_build.py) are read before the call and after the cards are
    synchronized."""
    from yololp_tpu_torch.ops import _build

    before = [_build.launches(k) for k in kernels]
    out = fn()
    sync_all()
    return out, [_build.launches(k) - n for k, n in zip(kernels, before)]


def _nms_custom_op(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float) -> torch.Tensor:
    from yololp_tpu_torch.ops import cuda_nms

    return cuda_nms.greedy_nms_mask_cuda(boxes, scores, iou_thres)


def phase_export(results, card, dev, inferer, ctx8, batch, runner_build, tmp):
    """21. Export on the card: the bf16 and int8 end2end programs of
    yololp_tpu_torch.export (plus their decode), as a .pt2 saved and loaded,
    as an AOTInductor package, and under the C++ runner. The artifacts are
    written into the directory `tmp`, where phase 25's runner leg finds the
    packages."""
    from yololp_tpu_torch.deploy import aoti_cpp
    from yololp_tpu_torch.export.export import build_export_fn, compile_aoti, export_program
    from yololp_tpu_torch.ops import cuda_conv, cuda_nms
    from yololp_tpu_torch.ops.nms import select_candidates
    from yololp_tpu_torch.quant.int8_infer import make_int8_infer_fn

    t_phase = time.perf_counter()
    staged = torch.from_numpy(batch).to(dev)
    lcg = torch.from_numpy(lcg_batch(BATCH, IMG)).to(dev)
    inferer8, amax, conf8 = ctx8["inferer8"], ctx8["amax"], ctx8["conf"]
    run8 = make_int8_infer_fn(inferer8.model, inferer8.variables, amax, conf_thres=conf8,
                              iou_thres=0.45, max_det=1000, conv_impl="conv", device=dev)
    flavours = [("bf16", inferer.model, inferer.variables, None, inferer.conf_thres,
                 lambda: inferer._run(staged)),
                ("int8", inferer8.model, inferer8.variables, amax, conf8, lambda: run8(staged))]
    out = {}
    for label, model, variables, calib, conf, eager in flavours:
        kw = dict(conf_thres=conf, iou_thres=0.45, max_det=1000)
        t0 = time.perf_counter()
        prog = export_program(WithDecode(build_export_fn(model, variables, calib_amax=calib,
                                                         **kw)), BATCH, IMG, dev)
        export_s = time.perf_counter() - t0
        nodes = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
        n_nms = sum("yololp_torch.greedy_nms_mask" in t for t in nodes)
        n_conv = sum("yololp_torch.int8_conv" in t for t in nodes)
        n_ba = sum("yololp_torch.bias_act" in t for t in nodes)
        n_q = sum("yololp_torch.quantize_codes" in t for t in nodes)
        want, (eager_nms, eager_conv, eager_ba, eager_q) = counted(
            eager, "greedy_nms", "int8_conv", "bias_act", "quantize")

        path = os.path.join(tmp, f"{label}.pt2")
        torch.export.save(prog, path)
        loaded = torch.no_grad()(torch.export.load(path).module())
        got, (nms_n, conv_n, ba_n, q_n) = counted(lambda: loaded(staged), "greedy_nms",
                                                  "int8_conv", "bias_act", "quantize")
        kept = nms_on_own_decode(got, kw, f"{label} .pt2")
        if ((nms_n, conv_n, ba_n, q_n) != (1, eager_conv, eager_ba, eager_q)
                or (n_nms, n_conv, n_ba, n_q) != (1, eager_conv, eager_ba, eager_q)
                or (eager_q > 0) != (calib is not None)):
            raise AssertionError(f"{label} .pt2: greedy_nms {nms_n}, int8_conv {conv_n}, "
                                 f"bias_act {ba_n}, quantize {q_n} launches a batch, {n_nms} / "
                                 f"{n_conv} / {n_ba} / {n_q} nodes; eager {eager_nms} / "
                                 f"{eager_conv} / {eager_ba} / {eager_q}")
        for name, a, b in zip(("det", "valid", "num"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{label} .pt2: {name} != the eager run's")
        print(f"[{card}] phase 21 {label}: torch.export in {export_s:.1f} s, "
              f"{n_nms} greedy_nms_mask, {n_conv} int8_conv, {n_ba} bias_act and {n_q} "
              f"quantize_codes nodes; the .pt2 saved and loaded: greedy_nms {nms_n}, int8_conv "
              f"{conv_n}, bias_act {ba_n}, quantize {q_n} launches a batch (eager {eager_nms} / "
              f"{eager_conv} / {eager_ba} / {eager_q}); "
              f"det/valid/num == plain CPU NMS on its own "
              f"decode (kept {kept[0]}..{kept[1]}) and == the eager run, bit for bit",
              flush=True)

        aoti_path, compile_s = compile_aoti(prog, os.path.join(tmp, f"{label}.aoti.pt2"))
        pkg = torch._inductor.aoti_load_package(aoti_path)
        got_a, (nms_a, conv_a, ba_a, q_a) = counted(lambda: pkg(staged), "greedy_nms",
                                                    "int8_conv", "bias_act", "quantize")
        kept = nms_on_own_decode(got_a, kw, f"{label} AOTInductor")
        # the package's epilogues and quantizes are Inductor's (export.inductor_program)
        if (nms_a, conv_a, ba_a, q_a) != (1, eager_conv, 0, 0):
            raise AssertionError(f"{label} AOTInductor: greedy_nms {nms_a}, int8_conv "
                                 f"{conv_a}, bias_act {ba_a}, quantize {q_a} launches a batch; "
                                 f"eager {eager_nms} / {eager_conv} / {eager_ba} / {eager_q}")
        # eager's decode: the .pt2's, which replays eager's ops bit for bit
        dec_a, dec_e = got_a[3].float().cpu(), got[3].float().cpu()
        err_px = float((dec_a[..., :13] - dec_e[..., :13]).abs().max())
        err_score = float((dec_a[..., 13:] - dec_e[..., 13:]).abs().max())
        same = [torch.equal(a, b) for a, b in zip(got_a[:3], want)]
        rows_differ = int((got_a[0] != want[0]).any(-1).sum())
        if not (err_px == 0 and err_score <= EXPORT_SCORE_ATOL and all(same[1:])):
            raise AssertionError(f"{label} AOTInductor vs eager: decode {err_px} px, "
                                 f"{err_score} score apart; valid, num equal: {same[1:]}")
        print(f"[{card}] phase 21 {label}: AOTInductor package compiled in {compile_s:.1f} s; "
              f"greedy_nms {nms_a}, int8_conv {conv_a}, bias_act {ba_a} launches a batch from "
              f"inside it; "
              f"det/valid/num == plain CPU NMS on its own decode (kept {kept[0]}..{kept[1]}); "
              f"its decode vs eager's max |diff| {err_px:.4g} px, {err_score:.4g} score "
              f"(tolerance 0 px, {EXPORT_SCORE_ATOL:.3g} score); "
              f"det/valid/num equal to eager's: {same} ({rows_differ} detection rows "
              f"differ)", flush=True)
        profile = profile_batch(lambda: pkg(staged), card, label=f"{label} AOTInductor")
        for kernel in ("greedy_nms_kernel",) + (("int8_conv_kernel",) if calib else ()):
            if not any(kernel in k for k in profile["by_name"]):
                raise AssertionError(f"{label} AOTInductor: {kernel} missing from the profile")

        times = {}
        for name, fn in (("eager", eager), ("pt2", lambda: loaded(staged)),
                         ("aoti", lambda: pkg(staged))):
            for _ in range(3):
                fn()
            ms = float(np.median(cuda_ms(fn, 2)))
            times[name] = dict(ms=ms, img_s=BATCH * 1e3 / ms)
        binary, build_s = runner_build.result()
        py_num = pkg(lcg)[2].cpu().tolist()
        rec = aoti_cpp.bench(binary, aoti_path, RUNNER_ITERS, BATCH, IMG)
        want_launches = {"greedy_nms": 1.0, "int8_conv": float(eager_conv), "bias_act": 0.0}
        if rec["first_num"] != py_num or rec["launches_per_batch"] != want_launches:
            raise AssertionError(f"{label} runner: num {rec['first_num']} (Python package "
                                 f"{py_num}), launches a batch {rec['launches_per_batch']} "
                                 f"(want {want_launches})")
        times["runner_sync"] = dict(ms=rec["sync"]["ms_per_batch"],
                                    img_s=rec["sync"]["images_per_sec"])
        times["runner_pipelined"] = dict(ms=rec["pipelined"]["ms_per_batch"],
                                         img_s=rec["pipelined"]["images_per_sec"])
        print(f"[{card}] phase 21 {label}: C++ runner (built in {build_s:.1f} s beside phases "
              f"4-20) --bench {RUNNER_ITERS} --batch {BATCH}: "
              f"first LCG batch's num == the Python package's ({min(py_num)}..{max(py_num)}), "
              f"launches a batch {rec['launches_per_batch']}")
        print(f"[{card}] phase 21 {label} img/s at batch {BATCH} (uint8 on the card in, "
              f"dets out; CUDA events, median of 5 windows of 2 batches; the runner by its "
              f"host clock): " + ", ".join(f"{k} {v['img_s']:.1f} ({v['ms']:.3f} ms)"
                                           for k, v in times.items()), flush=True)
        out[label] = dict(export_s=export_s, compile_s=compile_s,
                          nodes=[n_nms, n_conv, n_ba, n_q],
                          launches_pt2=[nms_n, conv_n, ba_n, q_n],
                          launches_aoti=[nms_a, conv_a, ba_a, q_a],
                          launches_eager=[eager_nms, eager_conv, eager_ba, eager_q],
                          decode_err_px=err_px,
                          decode_err_score=err_score, equal_to_eager=same,
                          det_rows_differ=rows_differ, times=times,
                          runner=rec, profile=profile, aoti_path=aoti_path)

    # host cost of an op dispatch against a direct call of the launcher
    pred = inferer.predict(staged)
    box_k, score_k, _ = select_candidates(pred, inferer.conf_thres, TOPK)
    nms_custom = torch.library.custom_op("yololp_smoke::greedy_nms_mask", _nms_custom_op,
                                         mutates_args=())
    x_q = torch.randint(-128, 128, (BATCH, 80, 80, 128), dtype=torch.int8, device=dev)
    w_q = torch.randint(-128, 128, (128, 3, 3, 128), dtype=torch.int8, device=dev)
    a, b = torch.full((128,), 1e-3, device=dev), torch.zeros(128, device=dev)
    us = {"greedy_nms": dict(
              op=host_us(lambda: torch.ops.yololp_torch.greedy_nms_mask(box_k, score_k, 0.45)),
              direct=host_us(lambda: cuda_nms.greedy_nms_mask_cuda(box_k, score_k, 0.45)),
              custom_op=host_us(lambda: nms_custom(box_k, score_k, 0.45)), per_batch=1),
          "int8_conv": dict(
              op=host_us(lambda: torch.ops.yololp_torch.int8_conv(x_q, w_q, a, b, 1, True,
                                                                    torch.int8)),
              direct=host_us(lambda: cuda_conv.int8_conv_cuda(x_q, w_q, a, b, 1, True,
                                                               torch.int8)),
              per_batch=out["int8"]["launches_aoti"][1])}
    for name, r in us.items():
        extra = r["per_batch"] * (r["op"] - r["direct"])
        print(f"[{card}] phase 21 dispatch: {name} through torch.ops {r['op']:.2f} us a call, "
              f"the launcher called directly {r['direct']:.2f} us"
              + (f", a torch.library.custom_op twin {r['custom_op']:.2f} us" if "custom_op" in r
                 else "")
              + f"; x {r['per_batch']} launches a batch = {extra:.1f} us a batch (host clock, "
              f"{DISPATCH_CALLS} calls)")
    out["dispatch_us"] = us
    out["seconds"] = time.perf_counter() - t_phase
    results["export"] = out
    print(f"phase 21 in {out['seconds']:.0f} s")
    return out


def spoiled_self_labels(preds, size, max_boxes):
    """self_labels of each frame's detections of positive size (random
    weights decode most boxes inverted) with every second label's
    characters moved (province + 3, ad2 + 1) and every third label's box
    narrowed to 0.6 of its width (IoU 0.6 with its detection: matched at
    0.5, not at 0.7), so that each stage of diag_strict's funnel has
    something to count; and every fourth label of the whole set widened to
    100 px (the detections of random weights are narrower than 40 px), so
    that diag_province's width buckets hold more than one."""
    preds = [d[(d[:, 2] - d[:, 0] > 1) & (d[:, 3] - d[:, 1] > 1)] for d in preds]
    labels, masks = self_labels(preds, size, max_boxes)
    n = 0
    for i in range(len(labels)):
        for j in range(int(masks[i].sum())):
            n += 1
            if n % 4 == 0:
                labels[i, j, 10] = 100 / size
                labels[i, j, 8] = np.clip(labels[i, j, 8], 50 / size, 1 - 50 / size)
            if j % 2 == 1:
                labels[i, j, 0] = (labels[i, j, 0] + 3) % 31
                labels[i, j, 4] = (labels[i, j, 4] + 1) % 37
            if j % 3 == 1:
                x1 = labels[i, j, 8] - labels[i, j, 10] / 2
                labels[i, j, 10] *= 0.6
                labels[i, j, 8] = x1 + labels[i, j, 10] / 2
    return labels, masks


def matched70(preds, targets):
    """Each image's targets whose best-IoU detection has IoU >= 0.7 (the
    headline gate of diag_strict.decompose)."""
    from yololp_tpu_torch.core.evaler import Evaler

    out = []
    for pred, tgt in zip(preds, targets):
        if len(pred) and len(tgt):
            tgt = tgt[Evaler._box_iou(pred[:, :4], tgt[:, 8:12]).max(0) >= 0.7]
        out.append(tgt)
    return out


def bmp_bytes(bgr: np.ndarray) -> bytes:
    """An uncompressed 24-bit BMP of a BGR uint8 image, written with numpy: a
    54-byte header, then bottom-up BGR rows padded to 4 bytes."""
    h, w = bgr.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = bgr[::-1].reshape(h, 3 * w)
    header = (b"BM" + np.array([54 + rows.size, 0, 54], "<u4").tobytes()
              + np.array([40, w, h], "<i4").tobytes() + np.array([1, 24], "<u2").tobytes()
              + np.array([0, rows.size, 2835, 2835, 0, 0], "<u4").tobytes())
    return header + rows.tobytes()


def bmp_decode(buf: bytes) -> np.ndarray:
    """The BGR uint8 image of a BMP as bmp_bytes writes it, read with numpy."""
    w, h = (int(v) for v in np.frombuffer(buf, "<i4", 2, 18))
    stride = (3 * w + 3) // 4 * 4
    rows = np.frombuffer(buf, np.uint8, h * stride, 54).reshape(h, stride)
    return np.ascontiguousarray(rows[::-1, :3 * w].reshape(h, w, 3))


def spied(inferer, call):
    """call() with the inferer's _run and predict watched: returns its
    result, the uint8 batch _run was given and (det, valid, num, decode)."""
    seen, saved = {}, dict(vars(inferer))
    run, predict = inferer._run, inferer.predict

    def spy_predict(images_u8):
        seen["pred"] = predict(images_u8)
        return seen["pred"]

    def spy_run(images_u8):
        seen["batch"] = np.array(images_u8)
        seen["out"] = run(images_u8)
        return seen["out"]

    inferer._run, inferer.predict = spy_run, spy_predict
    try:
        result = call()
    finally:
        vars(inferer).clear()
        vars(inferer).update(saved)
    return result, seen["batch"], (*seen["out"], seen["pred"])


def phase_encoded(results, card, dev, inferer, imgs):
    """22c. The encoded-image path on phase 4's frames written as BMPs: where
    OpenCV or cv2 exists, detect_batch_encoded's letterboxed batch against
    the host letterbox of numpy's own decode of the BMPs, its detections
    against the plain CPU NMS on its decode and against detect_batch on
    numpy's decode (branch 'library' or 'cv2'); where neither exists, the
    asserted refusal (branch 'refused')."""
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.data import native

    bufs = [bmp_bytes(im) for im in imgs]
    t0 = time.perf_counter()
    branch = "library" if native.native_available() else None  # builds where OpenCV is
    build_s = time.perf_counter() - t0
    if branch is None:
        try:
            branch = f"cv2 {native.require_cv2().__version__}"
        except RuntimeError:
            branch = "refused"
    if branch == "refused":
        refused = []
        for what, call in (
                ("Inferer.detect_batch_encoded", lambda: inferer.detect_batch_encoded(bufs[:1])),
                ("Evaler.init_data(native=True)",
                 lambda: Evaler({"val": "frames"}, device=dev).init_data("val", native=True))):
            try:
                call()
            except RuntimeError as e:
                if "neither the native batch decoder" not in str(e):
                    raise
                refused.append(what)
            else:
                raise AssertionError(f"{what} ran without OpenCV or cv2")
        print(f"encoded path: branch 'refused' (neither OpenCV's headers and libraries nor cv2 "
              f"on this machine): native_available() False; {' and '.join(refused)} raise the "
              "RuntimeError naming both")
        results["encoded"] = {"branch": branch, "refused": refused}
        return
    native.decode_letterbox_batch(bufs, IMG)  # warm-up
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        native.decode_letterbox_batch(bufs, IMG)
    decode_ms = (time.perf_counter() - t0) * 1e3 / reps
    decoded = [bmp_decode(b) for b in bufs]
    if not all(np.array_equal(d, im) for d, im in zip(decoded, imgs)):
        raise AssertionError("numpy's decode of the BMPs != the frames written")
    got, batch_enc, out_enc = spied(inferer, lambda: inferer.detect_batch_encoded(bufs))
    want, batch_np, _ = spied(inferer, lambda: inferer.detect_batch(decoded))
    if not np.array_equal(batch_enc, batch_np):
        raise AssertionError(f"branch {branch!r}: the decoder's letterboxed batch != the host "
                             "letterbox of numpy's decode")
    nms_on_own_decode(out_enc, dict(conf_thres=inferer.conf_thres, iou_thres=inferer.iou_thres,
                                    max_det=inferer.max_det), "detect_batch_encoded")
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"frame {i}: detect_batch_encoded != detect_batch")
    print(f"encoded path: branch {branch!r} (build {build_s:.1f} s): on {len(bufs)} BMP "
          "frames the decoder's letterboxed batch == the host letterbox of numpy's decode, "
          "detect_batch_encoded's detections == the plain CPU NMS on its decode == "
          f"detect_batch on numpy's decode, {sum(map(len, got))} detections; [{card}] host "
          "decode + letterbox "
          f"{decode_ms:.3f} ms per batch of {len(bufs)}")
    results["encoded"] = {"branch": branch, "build_s": build_s, "decode_ms": decode_ms}


def phase_diag(results, card, dev, inferer, imgs):
    """22. The diagnostics at full width (diag_strict, diag_province and
    utils/metrics on Evaler.predict of the bf16 yololps at 640 over phase
    12's 70 frames, labelled with the float model's own detections), the
    scan-wall diagnostic at its defaults, and the encoded-image path."""
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.tools import diag_province, diag_scan_walls, diag_strict
    from yololp_tpu_torch.utils.metrics import character_confusions

    t_phase = time.perf_counter()
    frames22, _, _ = labelled_frames(np.random.default_rng(SEED + 12), EVAL_FRAMES, IMG)
    ev = Evaler({}, batch_size=BATCH, img_size=IMG, conf_thres=inferer.conf_thres, device=dev)
    run_fn = ev.make_infer_fn(inferer.model)
    masks0 = np.zeros((EVAL_FRAMES, 32), np.float32)
    own, _ = ev.predict(run_fn, loader_batches(frames22, np.zeros((EVAL_FRAMES, 32, 20),
                                                                  np.float32), masks0, BATCH))
    labels, masks = spoiled_self_labels(own, IMG, 32)
    loader = loader_batches(frames22, labels, masks, BATCH)
    ev.speed_result = np.zeros(4)
    t0 = time.perf_counter()
    metric, launches, preds, _, targets = eval_on_card(ev, run_fn, inferer.model, loader,
                                                      ("greedy_nms",))
    check_s = time.perf_counter() - t0
    speed = ev.eval_speed()
    n_batches = -(-EVAL_FRAMES // BATCH)
    if launches != {"greedy_nms": n_batches}:
        raise AssertionError(f"diagnostics: greedy_nms launched {launches}, want {n_batches}")
    t0 = time.perf_counter()
    (stats, slot_total, slot_right, n_wrong), mats = diag_strict.report(metric, preds, targets)
    prov = diag_province.analyse(preds, targets)
    diag_s = time.perf_counter() - t0
    if not (stats["gt"] > 0 and stats["gt"] >= stats["matched50"] >= stats["matched70"]
            >= stats["both_ok"]):
        raise AssertionError(f"diag_strict funnel {stats}")
    acc = slot_right / np.maximum(slot_total, 1)
    if not ((acc >= 0) & (acc <= 1)).all() or int(n_wrong.sum()) != stats["matched70"]:
        raise AssertionError(f"per-slot accuracy {acc}, wrong-slot histogram {n_wrong}")
    wrong = int((slot_total - slot_right).sum())
    mats70 = character_confusions(preds, matched70(preds, targets))
    off_diag = sum(int(m.sum() - m.trace()) for m in mats70)
    if off_diag != wrong or wrong == 0:
        raise AssertionError(f"character_confusions on matched70 count {off_diag} wrong "
                             f"slots, decompose {wrong}")
    widths = np.concatenate([t[:, 10] - t[:, 8] for t in targets])
    edges = diag_province.WIDTH_EDGES
    per_bucket = [(lo, hi, int(((widths >= lo) & (widths < hi)).sum()))
                  for lo, hi in zip(edges[:-1], edges[1:])]
    if ([b[:3] for b in prov["buckets"]] != [b for b in per_bucket if b[2]]
            or len(prov["buckets"]) < 2 or not prov["gt"] == stats["gt"] == len(widths)):
        raise AssertionError(f"diag_province buckets {prov['buckets']} against the targets' "
                             f"widths {per_bucket} (want two or more) and gt {stats['gt']}")
    print(f"[{card}] diagnostics, yololps {IMG}px bf16, {EVAL_FRAMES} frames (self-labelled, "
          f"spoiled): greedy_nms launches {launches['greedy_nms']}, dets == plain CPU NMS; funnel "
          f"gt {stats['gt']} matched50 {stats['matched50']} matched70 {stats['matched70']} "
          f"corner_ok {stats['corner_ok']} cls_ok {stats['cls_ok']} both_ok {stats['both_ok']}; "
          f"wrong slots {wrong} == character_confusions' {off_diag}; province buckets "
          f"{[b[:3] for b in prov['buckets']]} == the targets' widths; Evaler.predict ms per image "
          f"{json.dumps(speed)}; predict + the plain CPU NMS check {check_s:.3f} s; "
          f"decompose + report + province {diag_s:.3f} s")
    walls = diag_scan_walls.main(["--device", str(dev)])
    bad = {k: v for k, v in walls.items() if k.endswith("_s") and not (np.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"diag_scan_walls: walls not finite and positive {bad}")
    phase_encoded(results, card, dev, inferer, imgs)
    results["diag"] = dict(stats=stats, slot_accuracy=acc.tolist(), launches=launches,
                           province_buckets=prov["buckets"], wrong_slots=wrong,
                           speed=speed, check_s=check_s, diag_s=diag_s, scan_walls=walls,
                           phase_s=time.perf_counter() - t_phase)
    print(f"phase 22 in {results['diag']['phase_s']:.0f} s")

# ---------------- phase 23: the spatial mesh ----------------

SPATIAL_MESHES = ((1, 2), (1, 4), (2, 2))
SPATIAL_PARITY_BATCH = 8
SPATIAL_BIG, SPATIAL_BIG_MESH = 2560, (1, 4)


def spatial_run(model, mesh, dtype, kw):
    """make_spatial_infer_fn's (run, put), and the decodes its NMS was given
    (ops/nms.py:non_max_suppression wrapped where spatial.py calls it)."""
    from yololp_tpu_torch.parallel import spatial

    run, put = spatial.make_spatial_infer_fn(model, mesh, dtype=dtype, pre_nms_topk=TOPK, **kw)
    decodes = []
    nms = spatial.non_max_suppression

    def recorded(images_u8):
        spatial.non_max_suppression = lambda pred, **k: decodes.append(pred) or nms(pred, **k)
        try:
            return run(images_u8)
        finally:
            spatial.non_max_suppression = nms

    return run, put, recorded, decodes


def spatial_parity(what, model, mesh, images_u8, want, kw):
    """One fp32 spatial batch: its NMS launches (n_data), its decode against
    the unsharded `want`, its detections against the plain CPU NMS on its
    own decode. Returns (launches, errors px and score, halo, kept min and
    max)."""

    run, put, recorded, decodes = spatial_run(model, mesh, torch.float32, kw)
    staged = put(images_u8)
    sync_all()
    out, (launches,) = counted(lambda: recorded(staged), "greedy_nms")
    if launches != len(mesh):
        raise AssertionError(f"{what}: {launches} greedy_nms launches for {len(mesh)} "
                             "data rows and one batch")
    pred = torch.cat([d.cpu() for d in decodes])
    if pred.shape != want.shape or not torch.isfinite(pred).all():
        raise AssertionError(f"{what}: decode {tuple(pred.shape)}, finite "
                             f"{bool(torch.isfinite(pred).all())}")
    err_px = float((pred[..., :13] - want[..., :13]).abs().max())
    err_score = float((pred[..., 13:] - want[..., 13:]).abs().max())
    if not (torch.allclose(pred[..., :13], want[..., :13], rtol=FP32_RTOL, atol=FP32_ATOL_PX)
            and torch.allclose(pred[..., 13:], want[..., 13:], rtol=0, atol=FP32_ATOL_SCORE)):
        raise AssertionError(f"{what}: fp32 spatial decode vs unsharded {err_px} px, "
                             f"{err_score} score")
    held_to_plain_nms(what, out, decodes, kw)
    run.close()
    return launches, err_px, err_score, dict(run.halo), int(out[2].min()), int(out[2].max())


def held_to_plain_nms(what, out, decodes, kw):
    """Each data row's detections in `out` (det, valid, num) against the
    plain CPU NMS on the decode that row's NMS was given."""
    from yololp_tpu_torch.ops.nms import non_max_suppression

    n = len(out[2]) // len(decodes)
    for i, d in enumerate(decodes):
        cpu = non_max_suppression(d.cpu(), pre_nms_topk=TOPK, **kw)
        for name, a, b in zip(("det", "valid", "num"), out, cpu):
            if not torch.equal(a[i * n:(i + 1) * n].cpu(), b):
                raise AssertionError(f"{what}: spatial detections != plain CPU NMS on the "
                                     f"spatial decode ({name}, data row {i})")


def spatial_bf16(what, model, mesh, images_u8, kw):
    """make_spatial_infer_fn's bf16 (run, staged bands), its first batch
    held to n_data greedy_nms launches and its detections to the plain CPU
    NMS on its own decodes."""

    run, put, recorded, decodes = spatial_run(model, mesh, torch.bfloat16, kw)
    staged = put(images_u8)
    sync_all()
    out, (launches,) = counted(lambda: recorded(staged), "greedy_nms")
    if launches != len(mesh):
        raise AssertionError(f"{what}: {launches} greedy_nms launches for "
                             f"{len(mesh)} data rows and one batch")
    held_to_plain_nms(what, out, decodes, kw)
    return run, staged


def host_enqueue_ms(fn, n: int = 5) -> float:
    """Median host ms of `fn` with no synchronisation inside (a card
    synchronisation between calls): what the host takes to enqueue it."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def peak_gib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def phase_spatial(results, card, dev, weights, cfg, inferer, batch):
    """23. Height-sharded inference over (data, spatial) meshes (see the
    module docstring)."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.parallel import data_spatial_mesh

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    where = ("every entry on cuda:0 (one card)" if n_cards == 1
             else f"entries wrapped round {n_cards} cards")
    kw = dict(conf_thres=inferer.conf_thres, iou_thres=inferer.iou_thres,
              max_det=inferer.max_det)
    inf32 = Inferer(".", weights, cfg, img_size=IMG, half=False, device=dev)
    small = batch[:SPATIAL_PARITY_BATCH]
    on_card = torch.as_tensor(batch).to(dev)  # both sides are timed from the card's memory
    want = inf32.predict(small).cpu()
    out = {"meshes": {}, "placement": where}
    launches = 0
    for shape in SPATIAL_MESHES:
        mesh = data_spatial_mesh(*shape, share=True)
        what = f"spatial {shape} fp32"
        n, err_px, err_score, halo, kept_lo, kept_hi = spatial_parity(
            what, inf32.model, mesh, small, want, kw)
        launches += n
        run, staged = spatial_bf16(f"spatial {shape} bf16", inferer.model, mesh, batch, kw)
        for _ in range(3):
            run(staged)
        ms = float(np.median(cuda_ms(lambda: run(staged), 2)))
        ms_plain = float(np.median(cuda_ms(lambda: inferer._run(on_card), 2)))
        host = host_enqueue_ms(lambda: run(staged))
        host_plain = host_enqueue_ms(lambda: inferer._run(on_card))
        run.close()
        out["meshes"][str(shape)] = dict(
            mesh=[[str(d) for d in row] for row in mesh], fp32_err_px=err_px,
            fp32_err_score=err_score, launches_per_batch=n, kept=[kept_lo, kept_hi],
            halo_fp32=halo, halo_bf16=dict(run.halo), bf16_ms=ms,
            bf16_unsharded_ms=ms_plain, host_enqueue_ms=host,
            host_enqueue_unsharded_ms=host_plain)
        print(f"[{card}] phase 23 spatial {shape} ({where}), yololps {IMG}px: fp32 batch "
              f"{SPATIAL_PARITY_BATCH} decode vs the unsharded _run decode max |diff| "
              f"{err_px:.4g} px, {err_score:.4g} score (tolerance rtol {FP32_RTOL} + "
              f"{FP32_ATOL_PX} px, {FP32_ATOL_SCORE} score); greedy_nms launches {n} a "
              f"batch; detections == plain CPU NMS on the spatial decode, fp32 and bf16 (kept "
              f"{kept_lo}..{kept_hi} in fp32); halo a forward {halo['rows']} rows, {halo['bytes']} B "
              f"(fp32, batch {SPATIAL_PARITY_BATCH}); bf16 batch {BATCH}: {ms:.3f} ms spatial, "
              f"{ms_plain:.3f} ms unsharded _run (both from batches on the card; CUDA events on "
              f"cuda:0, median of 5 windows of 2), halo {run.halo['rows']} rows, {run.halo['bytes']} B a forward; host "
              f"enqueue of a batch {host:.3f} ms spatial, {host_plain:.3f} unsharded (median of "
              f"5, no synchronisation inside)", flush=True)

    # one giant frame: the case the axis exists for
    big = np.ascontiguousarray(
        batch[:16].reshape(4, 4, IMG, IMG, 3).transpose(0, 2, 1, 3, 4).reshape(
            1, SPATIAL_BIG, SPATIAL_BIG, 3))
    mesh = data_spatial_mesh(*SPATIAL_BIG_MESH, share=True)
    want_big = inf32.predict(big).cpu()
    what = f"spatial {SPATIAL_BIG_MESH} {SPATIAL_BIG}px fp32"
    n, err_px, err_score, halo, kept_lo, _ = spatial_parity(what, inf32.model, mesh, big,
                                                            want_big, kw)
    launches += n
    del inf32, want_big
    torch.cuda.empty_cache()
    run, staged = spatial_bf16(f"spatial {SPATIAL_BIG_MESH} {SPATIAL_BIG}px bf16",
                               inferer.model, mesh, big, kw)
    big_on_card = torch.as_tensor(big).to(dev)
    for _ in range(3):
        run(staged)
        inferer._run(big_on_card)
    ms = float(np.median(cuda_ms(lambda: run(staged), 2)))
    ms_plain = float(np.median(cuda_ms(lambda: inferer._run(big_on_card), 2)))
    gib = peak_gib(lambda: run(staged))
    gib_plain = peak_gib(lambda: inferer._run(big_on_card))
    host = host_enqueue_ms(lambda: run(staged))
    host_plain = host_enqueue_ms(lambda: inferer._run(big_on_card))
    run.close()
    out["big"] = dict(size=SPATIAL_BIG, mesh=[[str(d) for d in row] for row in mesh],
                      fp32_err_px=err_px, fp32_err_score=err_score, kept=kept_lo,
                      halo_rows=halo["rows"], halo_bytes=halo["bytes"], bf16_ms=ms,
                      bf16_unsharded_ms=ms_plain, peak_gib=gib, peak_gib_unsharded=gib_plain,
                      host_enqueue_ms=host, host_enqueue_unsharded_ms=host_plain)
    print(f"[{card}] phase 23 spatial {SPATIAL_BIG_MESH} ({where}), one {SPATIAL_BIG}x"
          f"{SPATIAL_BIG} frame: fp32 decode vs the unsharded forward of the frame max |diff| "
          f"{err_px:.4g} px, {err_score:.4g} score; detections == plain CPU NMS, fp32 and "
          f"bf16 ({kept_lo} kept in fp32); halo {halo['rows']} rows, {halo['bytes']} B a forward; bf16 {ms:.3f} ms "
          f"spatial, {ms_plain:.3f} ms unsharded (CUDA events); peak memory {gib:.3f} GiB "
          f"spatial, {gib_plain:.3f} GiB unsharded; host enqueue {host:.3f} ms spatial, "
          f"{host_plain:.3f} unsharded", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    results["spatial"] = out
    print(f"phase 23 in {out['seconds']:.0f} s")
    return launches


NMS_ITERS = (1, 2, 16)  # phase 24: the fixed bounds held card against CPU


def equal_outputs(what, got, want):
    """det/valid/num of two NMS runs, equal bit for bit (on the host)."""
    for name, a, b in zip(("det", "valid", "num"), got, want):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: {name} differs")


def phase_nms_variants(results, card, dev, weights, cfg, inferer, batch, pred, ctx8):
    """24. The JAX NMS's variants on the card: the "approx" candidate
    selector on the bf16, int8 and sharded paths against "topk", and the
    fixed bound nms_iters against the CPU (see the module docstring)."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.ops import cuda_nms
    from yololp_tpu_torch.ops.nms import non_max_suppression, select_candidates
    from yololp_tpu_torch.parallel.infer import make_sharded_infer_fn
    from yololp_tpu_torch.quant import int8_infer
    from yololp_tpu_torch.tools import bench_nms

    t_phase = time.perf_counter()
    out = {}
    # bf16 Inferer._run, the selector given to the Inferer as the CLI gives it
    approx = Inferer(".", weights, cfg, img_size=IMG, half=True, iou_thres=inferer.iou_thres,
                     max_det=inferer.max_det, nms_selector="approx", device=dev)
    approx.conf_thres = inferer.conf_thres
    approx.warmup()
    want = inferer._run(batch)
    got, (n_nms,) = counted(lambda: approx._run(batch), "greedy_nms")
    if n_nms != 1:
        raise AssertionError(f"bf16 approx: {n_nms} greedy_nms launches for one batch")
    equal_outputs("bf16 _run approx vs topk", got, want)
    out["bf16"] = dict(greedy_nms_launches=n_nms, kept=[int(got[2].min()), int(got[2].max())])
    del approx

    # int8, phase 7's calibration and conf gate, the pallas plan
    inferer8, amax, conf8 = ctx8["inferer8"], ctx8["amax"], ctx8["conf"]
    kw8 = dict(conf_thres=conf8, iou_thres=0.45, max_det=1000, conv_impl="pallas", device=dev)
    run_t = int8_infer.make_int8_infer_fn(inferer8.model, inferer8.variables, amax, **kw8)
    run_a = int8_infer.make_int8_infer_fn(inferer8.model, inferer8.variables, amax,
                                          candidate_selector="approx", **kw8)
    want8 = run_t(batch)
    run_a(batch)
    got8, (n_nms8, n_conv8) = counted(lambda: run_a(batch), "greedy_nms", "int8_conv")
    if n_nms8 != 1 or n_conv8 < 30:
        raise AssertionError(f"int8 approx: greedy_nms {n_nms8}x, int8_conv {n_conv8}x a batch")
    equal_outputs("int8 approx vs topk", got8, want8)
    out["int8"] = dict(greedy_nms_launches=n_nms8, int8_conv_launches=n_conv8)
    del run_t, run_a

    # sharded, over phase 19's mesh
    two = torch.cuda.device_count() >= 2
    mesh = [dev, torch.device("cuda", 1) if two else dev]
    kw = dict(conf_thres=inferer.conf_thres, iou_thres=inferer.iou_thres, max_det=inferer.max_det,
              pre_nms_topk=TOPK)
    run_t, put = make_sharded_infer_fn(inferer.model, mesh, **kw)
    run_a, _ = make_sharded_infer_fn(inferer.model, mesh, candidate_selector="approx", **kw)
    staged = put(batch)
    want_s = run_t(staged)
    run_a(staged)
    got_s, (n_nms_s,) = counted(lambda: run_a(staged), "greedy_nms")
    if n_nms_s != len(mesh):
        raise AssertionError(f"sharded approx: {n_nms_s} greedy_nms launches, mesh of {len(mesh)}")
    equal_outputs("sharded approx vs topk", got_s, want_s)
    out["sharded"] = dict(greedy_nms_launches=n_nms_s, mesh=[str(d) for d in mesh])
    del run_t, run_a, staged
    print(f"[{card}] phase 24 approx selector == topk bit for bit (det, valid, num): bf16 _run "
          f"(greedy_nms {n_nms} a batch, kept {out['bf16']['kept'][0]}..{out['bf16']['kept'][1]}), "
          f"int8 pallas (greedy_nms {n_nms8}, int8_conv {n_conv8} a batch), sharded over "
          f"{len(mesh)} (greedy_nms {n_nms_s} a batch)", flush=True)

    # nms_iters on phase 4's decode: card == CPU, mask and detections
    nkw = dict(conf_thres=inferer.conf_thres, iou_thres=inferer.iou_thres, max_det=inferer.max_det)
    box_k, score_k, _ = select_candidates(pred, inferer.conf_thres, TOPK)
    exact = cuda_nms.greedy_nms_mask(box_k, score_k, inferer.iou_thres).cpu()
    pred_cpu, box_cpu, score_cpu = pred.cpu(), box_k.cpu(), score_k.cpu()
    out["iters"] = {}
    for it in NMS_ITERS:
        (mask, dets), (n_it,) = counted(lambda: (
            cuda_nms.greedy_nms_mask(box_k, score_k, inferer.iou_thres, iters=it),
            non_max_suppression(pred, nms_iters=it, **nkw)), "greedy_nms")
        if n_it:
            raise AssertionError(f"nms_iters={it} launched the exact kernel {n_it}x")
        if not torch.equal(mask.cpu(), cuda_nms.greedy_nms_mask(box_cpu, score_cpu,
                                                                inferer.iou_thres, iters=it)):
            raise AssertionError(f"nms_iters={it}: the card's keep-mask != the CPU's")
        equal_outputs(f"nms_iters={it} card vs CPU", dets,
                      non_max_suppression(pred_cpu, nms_iters=it, **nkw))
        out["iters"][it] = dict(slots_off_exact=int((mask.cpu() != exact).sum()),
                                kept=int(dets[2].sum()))
    print(f"[{card}] phase 24 nms_iters {NMS_ITERS} on phase 4's decode (B = {BATCH}, K = "
          f"{TOPK}): keep-mask and detections card == CPU, no greedy_nms launch; slots off the "
          f"exact mask " + ", ".join(f"{it}: {v['slots_off_exact']}" for it, v in
                                     out["iters"].items()), flush=True)

    # the 512-deep band chain: the bound bites
    boxes = torch.from_numpy(np.stack([chain_boxes(512)] * 4))
    scores = torch.from_numpy(np.tile(np.linspace(1, 0.5, 512, dtype=np.float32), (4, 1)))
    b_card, s_card = boxes.to(dev), scores.to(dev)
    chain16 = cuda_nms.greedy_nms_mask(b_card, s_card, 0.2, iters=16).cpu()
    if not torch.equal(chain16, cuda_nms.greedy_nms_mask(boxes, scores, 0.2, iters=16)):
        raise AssertionError("band chain, nms_iters=16: card != CPU")
    chain_exact = cuda_nms.greedy_nms_mask(b_card, s_card, 0.2).cpu()
    if torch.equal(chain16, chain_exact):
        raise AssertionError("band chain: nms_iters=16 equals the exact mask (the bound did not bite)")
    out["band_chain"] = dict(kept_iters16=int(chain16.sum()), kept_exact=int(chain_exact.sum()))
    print(f"[{card}] phase 24 512-deep band chain, nms_iters=16: card == CPU, kept "
          f"{int(chain16.sum())} against the exact mask's {int(chain_exact.sum())} (the bound bites)",
          flush=True)

    # the NMS stage's variants timed as the JAX tool times them
    bench = bench_nms.main(["--device", "cuda", "--batch-size", str(BATCH), "--iters", "8",
                            "--pre-nms-topk", str(TOPK)])
    grid = {k: bench[k] for k in ("topk_iters0_ms", "topk_iters16_ms", "approx_iters0_ms",
                                  "approx_iters16_ms", "candidate_only_topk_ms",
                                  "candidate_only_approx_ms")}
    out["bench_nms"] = grid
    print(f"[{card}] phase 24 bench_nms B = {bench['batch']}, A = {bench['anchors']}, K = "
          f"{bench['pre_nms_topk']} (utils/profiler.timed_scan, {bench['iters']} chained steps; "
          f"approx timed as {bench['approx_timed_as']}), "
          f"ms: " + ", ".join(f"{k} {v:.4f}" for k, v in grid.items()), flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    results["nms_variants"] = out
    print(f"phase 24 in {out['seconds']:.0f} s")
    return out


# ---------------- phase 25: the port's bench ----------------

BENCH_BATCH, BENCH_ITERS = 128, 20  # the bench's inference legs (its main()'s)
BENCH_TRAIN = ((32, 10), (128, 6))  # (batch, chained steps) of its train legs


def positive(what, x):
    if not (np.isfinite(x) and x > 0):
        raise AssertionError(f"{what}: {x} is not a positive number")
    return x


class RecordedNMS:
    """Within the block, `module.non_max_suppression` records each call's
    decode, keywords and (det, valid, num) in `calls`."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        self.real = real = self.module.non_max_suppression

        def spy(pred, **kw):
            out = real(pred, **kw)
            self.calls.append((pred, kw, out))
            return out

        self.module.non_max_suppression = spy
        return self.calls

    def __exit__(self, *exc):
        self.module.non_max_suppression = self.real


def own_decode_check(module, fwd, x, what):
    """One call of `fwd` (a leg's program, whose NMS lives in `module`) on
    `x`: its detections equal the plain CPU NMS on its own decode; returns
    (decode, the NMS's keywords, the kept range)."""
    with RecordedNMS(module) as calls:
        fwd(x)
    torch.cuda.synchronize()
    if len(calls) != 1:
        raise AssertionError(f"{what}: {len(calls)} NMS calls, want 1")
    pred, kw, out = calls[0]
    return pred, kw, nms_on_own_decode((*out, pred), kw, what)


def int8_decode_vs_plain(run, x, want_pred, what):
    """The int8 plan `run` again on `x` with every int8 conv in the plain
    version (exact fp64 accumulator, the same epilogue) on the card: its
    decode's boxes and corners equal `want_pred`'s bit for bit and its
    scores within EXPORT_SCORE_ATOL (phase 21's tolerance). Returns
    (max |diff| px, max |diff| score)."""
    from yololp_tpu_torch.ops import cuda_conv
    from yololp_tpu_torch.quant import int8_infer

    kernel = cuda_conv.int8_conv
    cuda_conv.int8_conv = cuda_conv.int8_conv_plain
    try:
        (plain_pred, *_), (n,) = counted(
            lambda: own_decode_check(int8_infer, run, x, f"{what}, plain int8_conv"), "int8_conv")
    finally:
        cuda_conv.int8_conv = kernel
    if n:
        raise AssertionError(f"{what}: the plain run launched int8_conv {n}x")
    err_px = float((plain_pred[..., :13] - want_pred[..., :13]).abs().max())
    err_score = float((plain_pred[..., 13:] - want_pred[..., 13:]).abs().max())
    if not (err_px == 0 and err_score <= EXPORT_SCORE_ATOL):
        raise AssertionError(f"{what}: decode with the kernel vs the plain version: {err_px} px, "
                             f"{err_score} score (want 0 px, {EXPORT_SCORE_ATOL:.3g} score)")
    return err_px, err_score


def phase_bench(results, card, dev, export, weights, cfg):
    """25. The port's bench on the card (see the module docstring)."""
    from yololp_tpu_torch import bench
    from yololp_tpu_torch.core.inferer import Inferer, deploy_decode
    from yololp_tpu_torch.ops.nms import select_candidates
    from yololp_tpu_torch.quant import int8_infer

    t_phase = time.perf_counter()
    b, k = BENCH_BATCH, BENCH_ITERS
    inferer = Inferer(".", None, "yololps", img_size=IMG, half=True, device=dev)
    model, state = inferer.model, inferer.variables
    line, launches = {}, {}

    (ips, ips_sync), (n_nms,) = counted(
        lambda: bench.bench_inference(model, b, IMG, iters=k, device=dev), "greedy_nms")
    # a warm and a timed call of k chained steps, then 1 + 5 synced batches
    if n_nms != 2 * k + 6:
        raise AssertionError(f"bench_inference: {n_nms} greedy_nms launches, want {2 * k + 6}")
    line["value"] = positive("bench_inference", ips)
    line["per_batch_sync_images_per_sec"] = positive("bench_inference sync", ips_sync)
    launches["inference"] = dict(greedy_nms=n_nms)
    # the legs' programs once more on a staged batch of theirs (bench._staged),
    # held to the plain versions: not counted above
    x = bench._staged(np.random.default_rng(0), b, IMG, dev)
    checks = dict(bf16=own_decode_check(bench, torch.inference_mode()(bench.e2e_fwd(model, dev)),
                                        x, f"bench e2e program b{b}")[2])

    plans = []
    real = int8_infer.make_int8_infer_fn

    def spy(*a, **kw):
        run = real(*a, **kw)
        plans.append((kw, run.int8_model, run))
        return run

    int8_infer.make_int8_infer_fn = spy
    try:
        ips8, (n_nms8, n_conv8) = counted(
            lambda: bench.bench_int8(model, state, b, IMG, iters=k, device=dev), "greedy_nms",
            "int8_conv")
    finally:
        int8_infer.make_int8_infer_fn = real
    per_step = export["int8"]["launches_eager"][1]
    if len(plans) != 1 or plans[0][0].get("stage_handoffs") is not True \
            or plans[0][0].get("conv_impl") != "conv" \
            or not any(isinstance(m, int8_infer.Int8Handoff) for m in plans[0][1].modules()):
        raise AssertionError(f"bench_int8 built {len(plans)} plans: "
                             f"{[p[0] for p in plans]}; want one conv plan with stage handoffs")
    if (n_nms8, n_conv8) != (2 * k, 2 * k * per_step):
        raise AssertionError(f"bench_int8: greedy_nms {n_nms8}, int8_conv {n_conv8} launches; "
                             f"want {2 * k} and {2 * k * per_step}")
    line["int8_images_per_sec"] = positive("bench_int8", ips8)
    launches["int8"] = dict(greedy_nms=n_nms8, int8_conv=n_conv8, int8_conv_per_step=per_step)
    run8 = plans[0][2]
    pred8, _, checks["int8"] = own_decode_check(int8_infer, run8, x, f"bench int8 plan b{b}")
    checks["int8_vs_plain"] = int8_decode_vs_plain(run8, x, pred8, f"bench int8 plan b{b}")
    del inferer, model, state, plans, run8, pred8
    torch.cuda.empty_cache()

    # the e2e program at b128 on phase 4's weights and phase 4's gate (2K
    # anchors of every image pass it), so that the kernel walks a full K
    model4 = Inferer(".", weights, cfg, img_size=IMG, half=True, device=dev).model
    with torch.inference_mode():
        gate = full_k_gate(deploy_decode(model4, x, dev, torch.bfloat16).float())
    full_k = dict(bench.NMS_KW, conf_thres=gate)
    (pred_k, _, kept), (n_k,) = counted(
        lambda: own_decode_check(bench, torch.inference_mode()(bench.e2e_fwd(model4, dev, full_k)),
                                 x, f"bench e2e program b{b}, full K"), "greedy_nms")
    topk = full_k["pre_nms_topk"]
    if n_k != 1 or not bool((select_candidates(pred_k, gate, topk)[1] > 0).all()):
        raise AssertionError(f"bench e2e program at gate {gate}: {n_k} greedy_nms launches, or "
                             f"fewer than {topk} candidates in an image")
    checks["bf16_full_k"] = dict(conf_thres=gate, k=topk, kept=kept)
    del model4, pred_k, x
    torch.cuda.empty_cache()

    peaks = {}
    for tb, ti in BENCH_TRAIN:
        torch.cuda.reset_peak_memory_stats(dev)
        rate = positive(f"bench_train_step b{tb}",
                        bench.bench_train_step(batch=tb, iters=ti, device=dev))
        peaks[tb] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        line[f"train_images_per_sec_b{tb}"] = rate
        line[f"train_ms_per_step_b{tb}"] = tb * 1e3 / rate
        torch.cuda.empty_cache()

    for label in ("int8", "bf16"):
        rec = bench.bench_native_runner(export[label]["aoti_path"], batch=BATCH, size=IMG)
        line[f"native_{label}_images_per_sec"] = positive(f"runner {label}",
                                                          rec["images_per_sec"])
        line[f"native_{label}_sync_images_per_sec"] = positive(f"runner {label} sync",
                                                               rec["sync_images_per_sec"])
    print(f"[{card}] phase 25 bench legs: inference b{b} {k} chained steps (greedy_nms "
          f"{n_nms} launches: one a step, 6 synced), int8 conv plan with stage handoffs built "
          f"once (greedy_nms {n_nms8}, int8_conv {n_conv8} = {per_step} a step), train "
          + ", ".join(f"b{tb} (peak {p:.2f} GiB)" for tb, p in peaks.items())
          + f", the runner on phase 21's b{BATCH} packages", flush=True)
    print(f"[{card}] phase 25 programs on one staged b{b} batch: e2e and int8 detections == the "
          f"plain CPU NMS on their own decode (kept {checks['bf16']}, {checks['int8']} at conf "
          f"{bench.NMS_KW['conf_thres']}); int8 decode, int8_conv kernel vs plain: "
          f"{checks['int8_vs_plain'][0]:.3g} px, {checks['int8_vs_plain'][1]:.3g} score; e2e at "
          f"phase 4's gate {gate:.6f} on its weights: full K = {topk}, one greedy_nms launch, "
          f"kept {kept}", flush=True)
    print(json.dumps({"bench": line}))
    out = dict(line=line, launches=launches, train_peak_gib=peaks, checks=checks,
               seconds=time.perf_counter() - t_phase)
    results["bench"] = out
    print(f"phase 25 in {out['seconds']:.0f} s")
    return out


# ---------------- phase 26: the deploy convs' epilogue (csrc/bias_act.cu) ----------------

# the benchmark cells' models and the biased convs of one deploy forward of
# each: the epilogue kernel launches once for each, in the residual form for
# each shortcut BottleRep
EPILOGUE_MODELS = {"yololps": (71, 0), "yolov6m": (108, 24)}
EPILOGUE_KERNELS = ("bias_act_kernel", "bias_act_residual_kernel")  # by form
# the batch of each CSP cell, whose residual calls phase 26 checks at their
# own shapes (kernel_cases.RESIDUAL_SHAPES at RESIDUAL_IMG)
RESIDUAL_BATCH = {"yolov6m": 128, "yolov6l6": 32}
class ParentEpilogue:
    """Within the block, every biased conv of `model` carries a no-op forward
    pre-hook, so `layers/blocks.py:conv_act` runs it as itself (cuDNN's conv,
    then PyTorch's broadcast add of the bias) and the activation after it,
    and a BottleRep's shortcut as PyTorch's alpha * x and add: the sequence
    the deploy graph ran before the epilogue kernel."""

    def __init__(self, model):
        self.model, self.handles = model, []

    def __enter__(self):
        self.handles = [m.register_forward_pre_hook(lambda mod, args: None)
                        for m in self.model.modules()
                        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                        and m.bias is not None]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def epilogue_calls(inferer, batch):
    """(C, H, W, act, dtype, form) of every epilogue call of one
    `inferer.predict`: form 0 bias_act, 1 its residual form."""
    from yololp_tpu_torch.ops import cuda_bias_act

    calls, real = [], cuda_bias_act.bias_act

    def spy(y, b, act, x=None, alpha=None):
        calls.append((y.shape[1], y.shape[2], y.shape[3], act, y.dtype, int(x is not None)))
        return real(y, b, act, x, alpha)

    cuda_bias_act.bias_act = spy
    try:
        inferer.predict(batch)
    finally:
        cuda_bias_act.bias_act = real
    return calls


def profiled_device_ms(fn, name, bound_ms, calls=10):
    """The device ms a call of `fn` in the kernels named `name`, by
    torch.profiler; a session that records none of them, or a reading under
    the bytes' bound, means the profiling session lost launches (CUPTI drops
    some, or all, late in a full run of this script on the H100), so it is
    taken again, up to 3 times, else None (not measured)."""
    from yololp_tpu_torch.utils.profiler import kernel_device_ms

    for _ in range(3):
        try:
            ms = kernel_device_ms(fn, name, calls=calls)
        except RuntimeError:  # no launch recorded in any of its sessions
            continue
        if ms >= bound_ms:
            return ms
    return None


def epilogue_form_times(shapes, gen, dev):
    """Per form present in `shapes` ({(C, H, W, act, form): calls a
    forward}): the kernel's time alone at b128 summed over a forward, on
    the device, the plain version's and the unfused sequence's, the bytes
    (y read and out written, x read besides in the residual form), the
    bound, the largest shape; and whether the kernel's SiLU rounds apart
    from PyTorch's on one of the shapes."""
    from yololp_tpu_torch.ops import cuda_bias_act

    forms, silu_apart = {}, False
    for (c, h, w, act, form), n in sorted(shapes.items()):
        y = epilogue_operand((EPILOGUE_BATCH, c, h, w), gen, dev)
        b = epilogue_operand((c,), gen, dev)
        args = (y, b, act)
        if form:
            args += (epilogue_operand(y.shape, gen, dev),
                     (1 + 0.1 * torch.randn(1, generator=gen, device=dev)).to(y.dtype))
        if act == 2:  # whether the kernel's SiLU rounds apart from PyTorch's here
            silu_apart |= not torch.equal(cuda_bias_act.bias_act(y, b, act),
                                          unfused_epilogue(y.clone(), b, act))
        kernel, plain = cuda_bias_act.bias_act, cuda_bias_act.bias_act_plain

        def library(args=args):
            out = unfused_epilogue(args[0], args[1], args[2])
            return out + args[4] * args[3] if len(args) > 3 else out

        size = (2 + form) * y.numel() * y.element_size()
        t = dict(kernel=float(np.median(cuda_ms(lambda: kernel(*args), 10, 3))),
                 device=profiled_device_ms(lambda: kernel(*args), EPILOGUE_KERNELS[form],
                                           size / HBM_BYTES_S * 1e3),
                 plain=float(np.median(cuda_ms(lambda: plain(*args), 2, 3))),
                 library=float(np.median(cuda_ms(library, 10, 3))))
        rec = forms.setdefault(form, dict(calls=0, shapes=0, bytes=0, largest=None,
                                          **{f"{k}_ms": 0.0 for k in t}))
        for k, v in t.items():
            rec[f"{k}_ms"] = None if rec[f"{k}_ms"] is None or v is None else rec[f"{k}_ms"] + n * v
        rec["calls"] += n
        rec["shapes"] += 1
        rec["bytes"] += n * size
        if rec["largest"] is None or size > rec["largest"]["bytes"]:
            rec["largest"] = dict(shape=[EPILOGUE_BATCH, c, h, w], act=act, bytes=size,
                                  bound_ms=size / HBM_BYTES_S * 1e3,
                                  **{f"{k}_ms": v for k, v in t.items()})
        del y, b, args
    for rec in forms.values():
        rec["bound_ms"] = rec["bytes"] / HBM_BYTES_S * 1e3
        rec["share_of_bound_alone"] = rec["bound_ms"] / rec["kernel_ms"]
        rec["share_of_bound_device"] = (rec["bound_ms"] / rec["device_ms"] if rec["device_ms"]
                                        else None)
    return forms, silu_apart


def residual_at_cell_shapes(gen, dev):
    """The residual form at every distinct (C, stride, act) of the CSP
    cells' residual calls, at each cell's own batch and size (yolov6m b128
    at 640, yolov6l6 b32 at 1280, ReLU and SiLU): kernel_cases.check_residual
    holds it bit for bit to the plain form's kernel then PyTorch's alpha * x
    and add. Per model: the shapes, the largest |difference| from that
    sequence and the largest ulps from the plain version."""
    from yololp_tpu_torch.ops import cuda_bias_act

    out = {}
    for model, shapes in RESIDUAL_SHAPES.items():
        n, img = RESIDUAL_BATCH[model], RESIDUAL_IMG[model]
        rec = dict(batch=n, img=img, shapes=0, acts=sorted({a for _, _, a in shapes}),
                   max_abs_diff=0.0, max_plain_ulps=0.0)
        for c, stride, act in shapes:
            y = epilogue_operand((n, c, img // stride, img // stride), gen, dev)
            args = (y, epilogue_operand((c,), gen, dev), act, epilogue_operand(y.shape, gen, dev),
                    (1 + 0.1 * torch.randn(1, generator=gen, device=dev)).to(y.dtype))
            got = cuda_bias_act.bias_act(*args)
            diff, ulps = check_residual(args, got, f"{model} b{n} {tuple(y.shape)} act {act}")
            rec["shapes"] += 1
            rec["max_abs_diff"] = max(rec["max_abs_diff"], diff)
            rec["max_plain_ulps"] = max(rec["max_plain_ulps"], ulps)
            del y, args, got
        torch.cuda.empty_cache()
        out[model] = rec
    return out


def phase_bias_act(results, card, dev):
    """26. The deploy convs' epilogue kernel (csrc/bias_act.cu) at every
    distinct shape of the yololps and yolov6m forwards at b128 in both of
    its forms (the card test holds it to its plain version there): the two
    deploy forwards at b128 against the parent's sequence (decode bit for
    bit where the kernel's SiLU rounds as PyTorch's) with the launches
    counted; per form, times alone beside the bound, the plain version and
    the unfused sequence, summed over a forward; the kernel's device time in
    a profiled forward. Then the residual form at the CSP cells' own shapes
    (residual_at_cell_shapes)."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.layers.fuse import fuse_model

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 26)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    out = {"models": {}}

    for name, (want_launches, want_residual) in EPILOGUE_MODELS.items():
        cfg, train = zoo_model(name, SEED + 26)
        weights = fuse_model(train).state_dict()
        del train
        inf = Inferer(".", weights, cfg, img_size=IMG, half=True, iou_thres=0.45,
                      max_det=1000, device=dev)
        calls = epilogue_calls(inf, np.zeros((1, IMG, IMG, 3), np.uint8))
        residual = sum(call[5] for call in calls)
        if (len(calls), residual) != (want_launches, want_residual):
            raise AssertionError(f"{name}: {len(calls)} epilogue calls a forward, {residual} "
                                 f"residual, want {want_launches}, {want_residual}")
        shapes = {}
        for c, h, w, act, dtype, form in calls:
            shapes[(c, h, w, act, form)] = shapes.get((c, h, w, act, form), 0) + 1
        forms, silu_apart = epilogue_form_times(shapes, gen, dev)

        batch = torch.from_numpy(rng.integers(0, 256, (EPILOGUE_BATCH, IMG, IMG, 3), np.uint8))
        batch = batch.pin_memory() if dev.type == "cuda" else batch  # as the benchmark stages
        fused, (launches,) = counted(lambda: inf.predict(batch), "bias_act")
        if launches != want_launches:
            raise AssertionError(f"{name}: {launches} bias_act launches a b{EPILOGUE_BATCH} "
                                 f"forward, want {want_launches}")
        with ParentEpilogue(inf.model):
            parent, (parent_launches,) = counted(lambda: inf.predict(batch), "bias_act")
            if parent_launches:
                raise AssertionError(f"{name}: the parent's sequence launched bias_act")
            parent_ms = float(np.median(cuda_ms(lambda: inf.predict(batch), 1, 3)))
            prof_parent = profile_batch(lambda: inf.predict(batch), card,
                                        label=f"{name} parent's epilogue", batch=EPILOGUE_BATCH)
        equal = torch.equal(fused, parent)
        err = float((fused - parent).abs().max())
        del parent
        if not equal and not silu_apart:
            raise AssertionError(f"{name}: the b{EPILOGUE_BATCH} decode differs from the "
                                 f"parent's sequence by up to {err}")
        fused_ms = float(np.median(cuda_ms(lambda: inf.predict(batch), 1, 3)))
        prof = profile_batch(lambda: inf.predict(batch), card, label=f"{name} fused epilogue",
                             batch=EPILOGUE_BATCH)
        for form, rec in forms.items():
            rec["in_forward_ms"] = sum(v for k, v in prof["by_name"].items()
                                       if EPILOGUE_KERNELS[form] in k)
        elementwise = {k: v for k, v in prof_parent["by_name"].items()
                       if "elementwise_kernel" in k}
        out["models"][name] = dict(launches=launches, residual_launches=residual,
                                   forms={EPILOGUE_KERNELS[f]: r for f, r in forms.items()},
                                   decode_equal=equal, decode_max_diff=err,
                                   silu_rounds_apart=silu_apart,
                                   forward_ms=dict(fused=fused_ms, parent=parent_ms),
                                   parent_elementwise_ms=elementwise)
        print(f"[{card}] phase 26 {name} b{EPILOGUE_BATCH}: {launches} bias_act launches a "
              f"forward ({residual} residual), decode == the parent's sequence: {equal} (max "
              f"|diff| {err:.3g}; SiLU rounds apart from PyTorch's: {silu_apart}); forward "
              f"{fused_ms:.3f} ms (parent's sequence {parent_ms:.3f} ms)", flush=True)
        for form, rec in forms.items():
            big = rec["largest"]
            print(f"[{card}] phase 26 {name} {EPILOGUE_KERNELS[form]}: {rec['calls']} calls "
                  f"({rec['shapes']} shapes), {rec['bytes'] / 1e9:.3f} GB, bound "
                  f"{rec['bound_ms']:.3f} ms; kernel alone {rec['kernel_ms']:.3f} ms "
                  f"({100 * rec['share_of_bound_alone']:.1f}% of bound), on device "
                  + (f"{rec['device_ms']:.3f} ms ({100 * rec['share_of_bound_device']:.1f}%)"
                     if rec["device_ms"] else "not measured (the profiler lost launches)")
                  + f", in the profiled forward {rec['in_forward_ms']:.3f} ms; plain "
                  f"{rec['plain_ms']:.3f} ms; unfused sequence {rec['library_ms']:.3f} ms; the "
                  f"largest shape {big['shape']} act {big['act']}: kernel {big['kernel_ms']:.3f} "
                  f"ms alone, {big['device_ms']} ms on device, bound {big['bound_ms']:.3f} ms",
                  flush=True)
        print(f"[{card}] phase 26 {name}: the parent's elementwise kernels: "
              + ", ".join(f"{v:.3f} ms {k[:60]}" for k, v in elementwise.items()), flush=True)
        del fused, inf, weights

    out["residual_check"] = residual_at_cell_shapes(gen, dev)
    for model, rec in out["residual_check"].items():
        print(f"[{card}] phase 26 residual form at {model}'s b{rec['batch']} {rec['img']}: "
              f"{rec['shapes']} shapes, acts {rec['acts']}, bit for bit with the plain form's "
              f"kernel then alpha * x and the add (max |diff| {rec['max_abs_diff']}), "
              f"{rec['max_plain_ulps']:.3g} ulps from the plain version at most", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    results["bias_act"] = out
    print(f"[{card}] phase 26 in {out['seconds']:.0f} s", flush=True)
    return out


# ---------------- phase 27: the NMS gate (csrc/nms_gate.cu) ----------------

GATE_SHAPES = {"yololps/yolov6m b128": (128, 8400), "yolov6l6 b32 1280": (32, 34000)}

def phase_nms_gate(results, card, dev):
    """27. The NMS gate kernel (csrc/nms_gate.cu) on the served yololps b128
    decode: bit for bit against its plain version, and the NMS stage with it
    against the plain gate; an exported program's nodes and launches; times
    alone and on device at the cells' shapes beside the bytes' bound (see
    the module docstring)."""
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.export.export import inductor_program
    from yololp_tpu_torch.layers.fuse import fuse_model
    from yololp_tpu_torch.ops import cuda_nms_gate
    from yololp_tpu_torch.ops import nms as nms_mod

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    out = {"cases": {}, "shapes": {}}
    errs = []

    def check(pred, thres, compat, what):
        args = (pred, thres, compat)
        passed, err = gate_equal(args, cuda_nms_gate.nms_gate(*args), what)
        errs.append(err)
        return passed

    # the served decode: yololps at 640, every parameter seeded, b128
    cfg, train = zoo_model("yololps", SEED + 27)
    inf = Inferer(".", fuse_model(train).state_dict(), cfg, img_size=IMG, half=True,
                  iou_thres=0.45, max_det=300, device=dev)
    del train
    rng = np.random.default_rng(SEED + 27)
    served = inf.predict(rng.integers(0, 256, (EPILOGUE_BATCH, IMG, IMG, 3), np.uint8))
    del inf
    median = float(cuda_nms_gate.nms_gate_plain(served, 0.0, False)[1].median())
    for thres in (0.4, median):
        for compat in (False, True):
            out["cases"][f"served b128 {thres:.6g} {compat}"] = check(
                served, thres, compat, "served yololps b128")

    nkw = dict(conf_thres=median, iou_thres=0.45, max_det=300)
    (det, valid, num), (gate_n, nms_n) = counted(
        lambda: nms_mod.non_max_suppression(served, **nkw), "nms_gate", "greedy_nms")
    # the stage as it ran before the op: the plain gate in the op's place, on the card
    op = cuda_nms_gate.nms_gate
    cuda_nms_gate.nms_gate = cuda_nms_gate.nms_gate_plain
    try:
        (p_det, p_valid, p_num), (p_gate_n, _) = counted(
            lambda: nms_mod.non_max_suppression(served, **nkw), "nms_gate", "greedy_nms")
        plain_stage_ms = float(np.median(cuda_ms(
            lambda: nms_mod.non_max_suppression(served, **nkw), 10, 5)))
    finally:
        cuda_nms_gate.nms_gate = op
    stage_ms = float(np.median(cuda_ms(lambda: nms_mod.non_max_suppression(served, **nkw),
                                       10, 5)))
    if (gate_n, nms_n, p_gate_n) != (1, 1, 0) or not all(
            torch.equal(a, b) for a, b in ((det, p_det), (valid, p_valid), (num, p_num))):
        raise AssertionError(f"non_max_suppression: gate launches {gate_n} (plain {p_gate_n}), "
                             f"greedy {nms_n}; equal to the plain gate's: "
                             f"{[torch.equal(a, b) for a, b in ((det, p_det), (valid, p_valid))]}")
    out["nms_stage"] = dict(ms=stage_ms, plain_gate_ms=plain_stage_ms, kept=num.tolist()[:8])
    print(f"[{card}] phase 27: {len(out['cases'])} cases bit for bit (max |diff| "
          f"{max(errs)}; passed rows "
          f"{out['cases']}); non_max_suppression on the served b128 decode at gate "
          f"{median:.6g}: one nms_gate and one greedy_nms launch, det/valid/num == the plain "
          f"gate's; the stage {stage_ms:.3f} ms (plain gate {plain_stage_ms:.3f} ms)",
          flush=True)

    # export: one node in the program and one launch from it; none after the decomposition
    class StageOnly(torch.nn.Module):
        def forward(self, p):
            return nms_mod.non_max_suppression(p, **nkw)

    small = served[:4].contiguous()
    with torch.no_grad():
        prog = torch.export.export(StageOnly(), (small,))
    n_node = sum("yololp_torch.nms_gate" in str(n.target) for n in prog.graph.nodes)
    n_inductor = sum("nms_gate" in str(n.target) for n in inductor_program(prog).graph.nodes)
    got, (n_launch,) = counted(lambda: torch.no_grad()(prog.module())(small), "nms_gate")
    want = StageOnly()(small)
    if (n_node, n_inductor, n_launch) != (1, 0, 1) or not all(
            torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"export: {n_node} nms_gate nodes, {n_inductor} after "
                             f"inductor_program, {n_launch} launches")
    out["export"] = dict(nodes=n_node, inductor_nodes=n_inductor, launches=n_launch)
    del served, det, p_det

    # the cells' shapes: times beside the bound
    for label, (b, a) in GATE_SHAPES.items():
        pred = gate_decode(b, a, gen, dev)
        rows = b * a
        nbytes = rows * (290 * 4 + 4 * 4 + 4 + 24 * 4 + 1)
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        fn = lambda: cuda_nms_gate.nms_gate(pred, 0.4, False)  # noqa: E731
        passed = int(fn()[3].sum())
        for _ in range(2):
            fn()
        alone = float(np.median(cuda_ms(fn, 100, 5)))
        device = profiled_device_ms(fn, "nms_gate_kernel", bound_ms, calls=20)
        plain = float(np.median(cuda_ms(lambda: cuda_nms_gate.nms_gate_plain(pred, 0.4, False),
                                        5, 3)))
        out["shapes"][label] = dict(batch=b, anchors=a, bytes=nbytes, bound_ms=bound_ms,
                                    alone_ms=alone, device_ms=device, plain_ms=plain,
                                    share_alone=bound_ms / alone,
                                    share_device=device and bound_ms / device, passed=passed)
        on_device = ("not measured (the profiler lost launches)" if device is None else
                     f"{device:.4f} ms ({100 * bound_ms / device:.1f}%)")
        print(f"[{card}] phase 27 {label} ({b} x {a}): {nbytes / 1e9:.4f} GB, "
              f"bound {bound_ms:.4f} ms; kernel alone {alone:.4f} ms "
              f"({100 * bound_ms / alone:.1f}% of bound), device {on_device}; "
              f"plain {plain:.3f} ms", flush=True)
        del pred
    out["max_abs_err"] = max(errs)
    out["seconds"] = time.perf_counter() - t_phase
    results["nms_gate"] = out
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the measurements to this JSON file")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.layers.fuse import fuse_model
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.ops import _build, cuda_nms
    from yololp_tpu_torch.ops.nms import non_max_suppression, select_candidates
    from yololp_tpu_torch.utils.config import Config

    dev = torch.device(DEVICE)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    results = {"card": card}

    # 2. build; the C++ runner (phase 21) builds beside the next phases
    t0 = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - t0
    print(f"built {_build.sources()} in {results['build_s']:.1f} s")
    runner_pool = ThreadPoolExecutor(max_workers=1)
    runner_build = runner_pool.submit(timed_build_runner)
    for name in _build.PTXAS_REPORT:
        regs = [u["registers"] for u in _build.ptxas_usage(name)]
        spills = sum(u["spill_bytes"] for u in _build.ptxas_usage(name))
        print(f"ptxas [{name}]: {len(regs)} kernel instances, {min(regs)}..{max(regs)} registers, "
              f"{spills} B spill stores (per instance: phases 8 and 11)")

    # 4. the main path
    rng = np.random.default_rng(SEED)
    cfg = Config.named("yololps")
    gen = torch.Generator().manual_seed(SEED)
    train = build_model(cfg, seed=SEED, device="cpu")
    randomize_parameters(train, gen)
    weights = fuse_model(train).state_dict()
    inferer = Inferer(".", weights, cfg, img_size=IMG, half=True, iou_thres=0.45,
                      max_det=1000, device=dev)
    imgs = frames(rng)
    batch = np.stack([inferer.precess_image(im) for im in imgs])
    pred = inferer.predict(batch)
    anchors = sum((IMG // s) ** 2 for s in (8, 16, 32))
    # a gate that 2K anchors of every image pass, so the kernel walks a full K
    _, score_all, _ = select_candidates(pred, 0.0, anchors)
    inferer.conf_thres = float(score_all[:, min(2 * TOPK, anchors) - 1].min())
    inferer.warmup()

    dets, (launches, gate_launches) = counted(lambda: inferer.detect_batch(imgs), "greedy_nms",
                                              "nms_gate")
    if launches < 1:
        raise AssertionError("the main path did not launch the greedy_nms kernel")
    if gate_launches != 1:
        raise AssertionError(f"the main path launched the nms_gate kernel {gate_launches} "
                             "times for one batch, not once")
    k = min(TOPK, anchors)
    n_max = min(inferer.max_det, k)
    for d in dets:
        if d.ndim != 2 or d.shape[1] != 28 or len(d) > n_max or not np.isfinite(d).all():
            raise AssertionError(f"bad detections {d.shape}")
    if len(dets) != BATCH or min(len(d) for d in dets) == 0:
        raise AssertionError("an image came back without detections")
    print(f"main path: yololps {IMG}px bf16, batch {BATCH}, conf_thres {inferer.conf_thres:.6f}, "
          f"greedy_nms launches {launches}, nms_gate launches {gate_launches}, detections per "
          f"image {min(map(len, dets))}..{max(map(len, dets))}")

    if pred.shape != (BATCH, anchors, 290) or pred.dtype != torch.float32:
        raise AssertionError(f"decode {tuple(pred.shape)} {pred.dtype}")
    if not torch.isfinite(pred).all():
        raise AssertionError("non-finite decode")
    kw = dict(conf_thres=inferer.conf_thres, iou_thres=inferer.iou_thres, max_det=inferer.max_det)
    box_k, score_k, _ = select_candidates(pred, inferer.conf_thres, TOPK)
    if not bool((score_k > 0).all()):
        raise AssertionError(f"the gate left fewer than {k} candidates in an image")
    card_out = non_max_suppression(pred, **kw)
    cpu_out = non_max_suppression(pred.cpu(), **kw)
    if [tuple(t.shape) for t in card_out] != [(BATCH, n_max, 28), (BATCH, n_max), (BATCH,)]:
        raise AssertionError(f"NMS shapes {[tuple(t.shape) for t in card_out]}")
    for name, a, b in zip(("det", "valid", "num"), card_out, cpu_out):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"card NMS != plain CPU NMS on the slice's decode ({name})")
    print(f"slice decode: card NMS == plain CPU NMS (keep, order, counts, dets); kept "
          f"{int(cpu_out[2].min())}..{int(cpu_out[2].max())} of {k}")

    inferer32 = Inferer(".", weights, cfg, img_size=IMG, half=False, device=dev)
    cpu32 = Inferer(".", weights, cfg, img_size=IMG, half=False, device="cpu")
    one = batch[:1]
    p_card, p_cpu = inferer32.predict(one).cpu(), cpu32.predict(one)
    err_px = float((p_card[..., :13] - p_cpu[..., :13]).abs().max())
    err_score = float((p_card[..., 13:] - p_cpu[..., 13:]).abs().max())
    if not (torch.allclose(p_card[..., :13], p_cpu[..., :13], rtol=FP32_RTOL, atol=FP32_ATOL_PX)
            and torch.allclose(p_card[..., 13:], p_cpu[..., 13:], rtol=0, atol=FP32_ATOL_SCORE)):
        raise AssertionError(f"fp32 decode card vs CPU: {err_px} px, {err_score} score")
    print(f"fp32 decode, card (TF32 off) vs CPU: max |diff| {err_px:.3g} px (of "
          f"{float(p_cpu[..., :13].abs().max()):.4g}), {err_score:.3g} score; "
          f"tolerance rtol {FP32_RTOL} + {FP32_ATOL_PX} px, {FP32_ATOL_SCORE} score")
    results.update(fp32_err_px=err_px, fp32_err_score=err_score, launches=launches,
                   gate_launches=gate_launches, conf_thres=inferer.conf_thres)

    # 5. times
    for label, inf in (("bf16", inferer), ("fp32", inferer32)):
        for _ in range(3):
            inf._run(batch)
        ms = cuda_ms(lambda: inf._run(batch), 2)
        t0 = time.perf_counter()
        for _ in range(3):
            inf.detect_batch(imgs)
        host_s = (time.perf_counter() - t0) / 3
        img_s = BATCH * 1e3 / float(np.median(ms))
        results[f"e2e_{label}"] = dict(median_ms=float(np.median(ms)), img_s=img_s,
                                       detect_batch_img_s=BATCH / host_s, runs_ms=ms)
        print(f"[{card}] end-to-end {label} batch {BATCH}: {img_s:.1f} img/s "
              f"(median of 5 windows of 2 batches, {np.median(ms):.3f} ms per batch of uint8 in -> dets out, CUDA events); "
              f"detect_batch with host letterbox {BATCH / host_s:.1f} img/s")

    results["profile_bf16"] = profile_batch(lambda: inferer._run(batch), card)
    nms = phase_nms_times(results, card, cuda_nms, box_k, score_k, inferer.iou_thres, pred, kw)

    # 7-8. the int8 main path and its times
    int8_launches, run_err, tot, ctx8 = phase_int8_main(results, card, dev, cfg, weights, batch,
                                                        imgs, rng, inferer32, cpu32)

    # 10. the dots int8 main path; 11. times
    mm_launches, mm_shapes = phase_dots_main(results, card, dev, batch, imgs, ctx8)
    mm_tot = phase_matmul_times(results, card, dev, rng, mm_shapes, ctx8["amax"], inferer.model)

    # 12. the evaler on the card; 13. the train forward, assignment, loss and backward
    phase_eval(results, card, dev, inferer, ctx8)
    phase_train(results, card, dev, train, cfg)
    # 14. the training path: optimizer steps, QAT, times, the Trainer and its checkpoint
    eval_frames = labelled_frames(np.random.default_rng(SEED + 12), EVAL_FRAMES, IMG)
    phase_training(results, card, dev, train, cfg, ctx8["amax"], eval_frames)

    # 15. the zoo's deploy inference at published width and depth; 15b. the zoo under --int8
    t_zoo = time.perf_counter()
    phase_zoo(results, card, dev, batch)
    phase_zoo_int8(results, card, dev, batch)
    # 16. a zoo train step with the DFL loss
    cfg_m, train_m = zoo_model("yolov6m", SEED + 16)
    phase_train(results, card, dev, train_m, cfg_m, name="yolov6m", n_time=ZOO_TRAIN_BATCH,
                key="zoo_train", seed=SEED + 160)
    del train_m
    # 17. RepOpt; 18. distillation and the sensitivity analysis
    phase_repopt(results, card, dev, eval_frames)
    phase_distill(results, card, dev)
    results["zoo_phases_s"] = time.perf_counter() - t_zoo
    print(f"phases 15-18 in {results['zoo_phases_s']:.0f} s")

    # 19. sharded inference and eval; 20. data-parallel training
    t_mg = time.perf_counter()
    phase_sharded(results, card, dev, inferer, batch)
    phase_ddp(results, card, dev, train, cfg, eval_frames)
    results["multi_gpu_phases_s"] = time.perf_counter() - t_mg
    print(f"phases 19-20 in {results['multi_gpu_phases_s']:.0f} s")

    # 21. export: the .pt2, the AOTInductor packages and the C++ runner
    export_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_export_")
    export = phase_export(results, card, dev, inferer, ctx8, batch, runner_build, export_dir.name)
    runner_pool.shutdown()

    # 22. the diagnostics at full width, the scan walls and the encoded-image path
    phase_diag(results, card, dev, inferer, imgs)

    # 23. the spatial mesh: height-sharded inference with halo exchange
    spatial_launches = phase_spatial(results, card, dev, weights, cfg, inferer, batch)

    # 24. NMS's variants: the approx selector on every path, the nms_iters bound
    variants = phase_nms_variants(results, card, dev, weights, cfg, inferer, batch, pred, ctx8)

    # 25. the port's bench: its legs at full size, the runner on phase 21's packages
    phase_bench(results, card, dev, export, weights, cfg)
    export_dir.cleanup()

    # 26. the deploy convs' epilogue kernel at the benchmark cells' shapes
    epilogue = phase_bias_act(results, card, dev)
    plain_form = epilogue["models"]["yololps"]["forms"]["bias_act_kernel"]

    # 27. the NMS gate kernel at the benchmark cells' shapes
    gate = phase_nms_gate(results, card, dev)

    nms32, nms1 = nms["by_batch"][BATCH], nms["by_batch"][1]
    quant = results["int8"]["quantize"]
    kernels = [{"name": "greedy_nms", "route": "cuda",
                "source": "yololp_tpu_torch/csrc/greedy_nms.cu",
                "replaces": "yololp_tpu/ops/pallas_nms.py:29",
                "launches": launches, "max_abs_err": None, "ms": nms32["ms"],
                "plain_ms": nms32["plain_ms"], "bound_ms": nms32["bound_ms"],
                "bound_by": nms32["bound_by"], "library_ms": None, "matches_plain": True,
                "device_ms": nms32["device_ms"], "kept": nms32["kept"],
                "ms_b1": nms1["ms"], "device_ms_b1": nms1["device_ms"], "kept_b1": nms1["kept"],
                "device_ms_in_batch": nms["in_batch_device_ms"],
                "export_launches": {k: export[k]["launches_aoti"][0] for k in ("bf16", "int8")},
                "runner_launches": {k: export[k]["runner"]["launches_per_batch"]["greedy_nms"]
                                    for k in ("bf16", "int8")},
                "spatial_launches": spatial_launches,
                "approx_launches": {k: variants[k]["greedy_nms_launches"]
                                    for k in ("bf16", "int8", "sharded")}},
               {"name": "int8_conv", "route": "cuda",
                "source": "yololp_tpu_torch/csrc/int8_conv.cu",
                "replaces": "yololp_tpu/ops/pallas_conv.py:58",
                "launches": int8_launches, "max_abs_err": run_err,
                "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": "bytes" if tot["bytes"] / HBM_BYTES_S > tot["ops"] / INT8_OPS_S
                else "operations",
                "library_ms": None, "matches_plain": True,
                "export_launches": {"int8": export["int8"]["launches_aoti"][1]},
                "runner_launches": {"int8": export["int8"]["runner"]["launches_per_batch"]
                                    ["int8_conv"]}},
               {"name": "mxu_matmul", "route": "cuda",
                "source": "yololp_tpu_torch/csrc/mxu_matmul.cu",
                "replaces": "tools/probe_mxu_int8.py:44",
                "launches": mm_launches, "max_abs_err": None,
                # this run holds only the int8 dots route to its exact accumulator
                # (phase 10); the bf16 kernel is the card test's
                "tolerance": "int8 exact (phase 10, the dots route)",
                "bf16_checked_by": "tests/test_torch_cuda.py -m cuda",
                "ms": mm_tot["ms"], "plain_ms": mm_tot["plain_ms"], "bound_ms": mm_tot["bound_ms"],
                "bound_by": mm_tot["bound_by"],
                "library_ms": (mm_tot["library_ms"]
                               if mm_tot["library_launches"] == mm_tot["launches"] else None),
                "library_ms_where_defined": mm_tot["library_ms"],
                "library_launches": mm_tot["library_launches"], "matches_plain": True},
               {"name": "bias_act", "route": "cuda",
                "source": "yololp_tpu_torch/csrc/bias_act.cu",
                "replaces": None,
                "launches": epilogue["models"]["yololps"]["launches"],
                "max_abs_err": None,
                "silu_rounds_apart": {k: v["silu_rounds_apart"]
                                      for k, v in epilogue["models"].items()},
                "ms": plain_form["kernel_ms"], "device_ms": plain_form["device_ms"],
                "plain_ms": plain_form["plain_ms"], "bound_ms": plain_form["bound_ms"],
                "bound_by": "bytes", "library_ms": plain_form["library_ms"],
                "matches_plain": True,
                "residual_form": dict(
                    epilogue["models"]["yolov6m"]["forms"]["bias_act_residual_kernel"],
                    checked_at_cell_shapes=epilogue["residual_check"],
                    max_abs_diff=max(r["max_abs_diff"]
                                     for r in epilogue["residual_check"].values())),
                "export_launches": {k: export[k]["launches_pt2"][2] for k in ("bf16", "int8")},
                "aoti_launches": {k: export[k]["launches_aoti"][2] for k in ("bf16", "int8")},
                "runner_launches": {k: export[k]["runner"]["launches_per_batch"]["bias_act"]
                                    for k in ("bf16", "int8")}},
               {"name": "nms_gate", "route": "cuda",
                "source": "yololp_tpu_torch/csrc/nms_gate.cu",
                "replaces": None, "launches": gate_launches, "max_abs_err": gate["max_abs_err"],
                "ms": gate["shapes"]["yololps/yolov6m b128"]["alone_ms"],
                "device_ms": gate["shapes"]["yololps/yolov6m b128"]["device_ms"],
                "plain_ms": gate["shapes"]["yololps/yolov6m b128"]["plain_ms"],
                "bound_ms": gate["shapes"]["yololps/yolov6m b128"]["bound_ms"],
                "bound_by": "bytes", "library_ms": None, "matches_plain": True,
                "export_nodes": gate["export"]["nodes"],
                "aoti_nodes": gate["export"]["inductor_nodes"]},
               {"name": "quantize", "route": "cuda",
                "source": "yololp_tpu_torch/csrc/quantize.cu",
                "replaces": None, "launches": quant["launches"], "max_abs_err": 0.0,
                "ms": quant["ms"], "device_ms": quant["device_ms"],
                "plain_ms": quant["plain_ms"], "bound_ms": quant["bound_ms"],
                "bound_by": "bytes", "library_ms": None, "matches_plain": True,
                "checked_at_plan_shapes": len(results["int8"]["quantize_timed"]),
                "batch": EPILOGUE_BATCH, "recorded": quant["recorded"],
                "export_launches": {"int8": export["int8"]["launches_pt2"][3]},
                "aoti_launches": {"int8": export["int8"]["launches_aoti"][3]}}]
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
