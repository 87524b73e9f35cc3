#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (yololp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one NVIDIA card and the CUDA
toolkit. Phases, each of which raises on failure:

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every kernel of csrc/ with nvcc (one process per source, in parallel);
  3. the greedy-NMS kernel against its plain PyTorch version, exact keep-mask
     equality, on clustered boxes, a conf-gated zero tail, exact score ties,
     degenerate boxes, a 128-deep suppression chain and K = 1024;
  4. the main path: yololps at full width, every parameter drawn from a seeded
     generator, fused to the deploy graph, `Inferer.detect_batch` on 32 BGR
     frames at 640x640 and 360x640 (pad only, no cv2), with the kernel's launch
     count read around that call; then the card's (32, 8400, 290) decode
     through the plain NMS on the CPU (exact equality), and one image in fp32
     with TF32 off on the card against the port on the CPU;
  5. times, by CUDA events: end-to-end img/s at batch 32 in bf16 and fp32, a
     torch.profiler table of one bf16 batch by kernel, and the NMS kernel and
     its plain version on the main path's own candidates.

It prints the kernels line and, last, {"ok": true, "device": {...}}. Without a
card it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 32
IMG = 640
SEED = 0
DEVICE = "cuda:0"
TOPK = 512  # the NMS's pre_nms_topk: the kernel's K on the main path
# fp32 card-vs-CPU decode: cuDNN and the CPU library sum conv products in
# other orders (and may pick Winograd), compounded over ~70 convs.
FP32_RTOL, FP32_ATOL_PX, FP32_ATOL_SCORE = 2e-3, 0.1, 2e-3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor fp32 op/s
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
# operations per (i, j) pair of the IoU bitmask: 2 max, 2 min, 2 sub, 2 clip,
# 1 mul, 2 add, 1 sub, 1 div, 1 compare; plus 5 per box for its area
IOU_PAIR_OPS, AREA_OPS = 15, 5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def clustered_boxes(rng, n, n_clusters=8, scale=640.0):
    """Overlapping clusters of xyxy boxes (the generator of tests/test_nms.py)."""
    centers = rng.uniform(50, scale - 50, size=(n_clusters, 2))
    idx = rng.integers(0, n_clusters, size=n)
    cxy = centers[idx] + rng.normal(0, 12, size=(n, 2))
    wh = rng.uniform(20, 80, size=(n, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


def mask_cases(rng):
    """name -> (boxes (B, K, 4), score-sorted scores (B, K), iou_thres)."""
    def scores(b, k):
        return np.sort(rng.uniform(0.01, 1.0, (b, k)).astype(np.float32), -1)[:, ::-1].copy()

    boxes = np.stack([clustered_boxes(rng, 512) for _ in range(BATCH)])
    gated = scores(BATCH, 512)
    gated[:, 300:] = 0.0
    tied = scores(BATCH, 512)
    tied[:, 50:250] = tied[:, 50:51]
    flipped = boxes.copy()
    flipped[:, ::3] = flipped[:, ::3][..., [2, 3, 0, 1]]
    xs = np.arange(128, dtype=np.float32) * 6.0
    chain = np.stack([xs, np.zeros(128, np.float32), xs + 10.0, np.full(128, 10.0, np.float32)], -1)
    return {
        "clustered_B32_K512": (boxes, scores(BATCH, 512), 0.45),
        "conf_gated_zero_tail": (boxes, gated, 0.45),
        "exact_score_ties": (boxes, tied, 0.45),
        "degenerate_boxes": (flipped, scores(BATCH, 512), 0.45),
        "chain_128_deep": (np.stack([chain] * 4), np.tile(np.linspace(1, 0.5, 128, dtype=np.float32), (4, 1)), 0.2),
        "clustered_K1024": (np.stack([clustered_boxes(rng, 1024) for _ in range(8)]), scores(8, 1024), 0.45),
    }


@torch.no_grad()
def randomize_parameters(model: torch.nn.Module, gen: torch.Generator, gain: float = 0.7):
    """Every kernel He-style (std gain/sqrt(fan_in)), BN scale and variance in
    [0.5, 1.5], BN shift and mean ~N(0, 0.1), conv biases init + N(0, 0.1): so
    the head scores vary and activations stay finite through the deep graph."""
    def normal(t, std):
        return torch.randn(t.shape, generator=gen) * std

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            w.copy_(normal(w, gain / fan_in ** 0.5))
            if m.bias is not None:
                m.bias.add_(normal(m.bias, 0.1))
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
            m.bias.copy_(normal(m.bias, 0.1))
            m.running_mean.copy_(normal(m.running_mean, 0.1))


def frames(rng):
    """BGR frames: 640x640, and 360x640 which the letterbox only pads (no cv2)."""
    return [rng.integers(0, 256, (IMG if i % 4 else IMG * 9 // 16, IMG, 3), np.uint8)
            for i in range(BATCH)]


def profile_batch(fn, card: str, calls: int = 2) -> dict:
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(f"[{card}] profile, one bf16 batch of {BATCH}: window {window_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}%), "
          f"{len(kernels)} kernel names")
    for name, ms in top:
        print(f"  {ms:8.3f} ms {100 * ms / window_ms:5.1f}%  {name[:110]}")
    return dict(window_ms=window_ms, busy_ms=busy_ms, top=top)


def phase_kernels(cuda_nms, rng, dev):
    worst = 0
    for name, (boxes, scores, thr) in mask_cases(rng).items():
        b, s = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
        got = cuda_nms.greedy_nms_mask(b, s, thr)
        torch.cuda.synchronize()
        plain_card = cuda_nms.greedy_nms_mask_plain(b, s, thr)
        plain_cpu = cuda_nms.greedy_nms_mask_plain(b.cpu(), s.cpu(), thr)
        err = int((got.cpu().int() - plain_cpu.int()).abs().max())
        if not (torch.equal(got, plain_card) and err == 0):
            raise AssertionError(f"greedy_nms kernel != plain on {name}: "
                                 f"{int((got.cpu() != plain_cpu).sum())} slots differ")
        worst = max(worst, err)
        print(f"kernel vs plain [{name}] B={b.shape[0]} K={b.shape[1]}: equal, "
              f"kept {int(got.sum())}/{got.numel()}")
    return worst


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the measurements to this JSON file")
    args = parser.parse_args()
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

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - t0
    print(f"built {_build.sources()} in {results['build_s']:.1f} s")
    for name, report in _build.PTXAS_REPORT.items():
        print(f"ptxas [{name}]: " + " | ".join(l for l in report.splitlines() if "Used" in l))

    # 3. kernel vs plain
    rng = np.random.default_rng(SEED)
    max_err = phase_kernels(cuda_nms, rng, dev)

    # 4. the main path
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

    cuda_nms.launches = 0
    dets = inferer.detect_batch(imgs)
    torch.cuda.synchronize()
    launches = cuda_nms.launches
    if launches < 1:
        raise AssertionError("the main path did not launch the greedy_nms kernel")
    k = min(TOPK, anchors)
    n_max = min(inferer.max_det, k)
    for d in dets:
        if d.ndim != 2 or d.shape[1] != 28 or len(d) > n_max or not np.isfinite(d).all():
            raise AssertionError(f"bad detections {d.shape}")
    if len(dets) != BATCH or min(len(d) for d in dets) == 0:
        raise AssertionError("an image came back without detections")
    print(f"main path: yololps {IMG}px bf16, batch {BATCH}, conf_thres {inferer.conf_thres:.6f}, "
          f"greedy_nms launches {launches}, detections per image "
          f"{min(map(len, dets))}..{max(map(len, dets))}")

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
                   conf_thres=inferer.conf_thres)

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

    thr = inferer.iou_thres
    for _ in range(5):
        cuda_nms.greedy_nms_mask(box_k, score_k, thr)
    kernel_ms = float(np.median(cuda_ms(lambda: cuda_nms.greedy_nms_mask(box_k, score_k, thr), 100)))
    plain_ms = float(np.median(cuda_ms(lambda: cuda_nms.greedy_nms_mask_plain(box_k, score_k, thr), 4)))
    b = score_k.shape[0]
    bytes_moved = b * k * (16 + 4 + 1)
    ops = b * (k * (k - 1) // 2 * IOU_PAIR_OPS + k * AREA_OPS)
    bound_ms = max(bytes_moved / HBM_BYTES_S, ops / FP32_OPS_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_S > ops / FP32_OPS_S else "operations"
    print(f"[{card}] greedy_nms B={b} K={k}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(CUDA events, median of 5 windows of 100 and 4 calls), bound {bound_ms:.5f} ms by {bound_by}")

    kernels = [{"name": "greedy_nms", "route": "cuda",
                "source": "yololp_tpu_torch/csrc/greedy_nms.cu",
                "replaces": "yololp_tpu/ops/pallas_nms.py:29",
                "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "matches_plain": True}]
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
