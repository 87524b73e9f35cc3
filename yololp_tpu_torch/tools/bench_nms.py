"""NMS-stage bench (counterpart of tools/bench_nms.py).

Times `non_max_suppression` end to end on realistic decoded predictions at
serving shape (default B = 128, A = 8400 anchors at 640 px): ~1.5% of the
anchors carry confident per-task scores, so the confidence gate leaves a
zero tail in the K = 512 candidates of every image. As the JAX tool, it
times each candidate selector ("topk", "approx") with each keep-mask
(nms_iters 0, the exact mask of the CUDA kernel, and 16, the fixed bound of
16 update steps in plain PyTorch ops): `<selector>_iters<N>_ms`. Off the TPU
"approx" selects as "topk" does (ops/nms.py): the two selectors run one
program, so each program is timed once and the `approx_*` keys hold the
`topk_*` measurement (`approx_timed_as: "topk"` says so). Beside them: the
candidate selection alone (`candidate_only_<selector>_ms`: gate, ranking
score and the stable sort that takes the top K, with no gathers,
suppression or compaction; one measurement as well), and the
greedy keep-mask
alone on this traffic's candidates (the CUDA kernel csrc/greedy_nms.cu on
the card, its plain version on the CPU), with the candidates and kept boxes
per image, since the kernel's walk takes one step per kept box. On the card
it also reads the kernel's own device time with torch.profiler
(`greedy_nms_kernel_device_ms`; absent on the CPU).

Protocol: utils/profiler.timed_scan (K chained steps in one timed call; each
step shifts the decode's x centers in place by 1e-6 px times the step count,
so the chain adds no pass over the whole decode). Prints one JSON object.

    python -m yololp_tpu_torch.tools.bench_nms --device cuda
    python -m yololp_tpu_torch.tools.bench_nms --device cpu --small
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import kernel_device_ms, timed_scan


def decode_traffic(b: int, a: int, seed: int = 0) -> np.ndarray:
    """(B, A, 290) decoded predictions, as the JAX tool makes them: boxes
    spread over the frame, every anchor at obj 1, and per task one class at
    0.02, or at U(0.5, 1) on the ~1.5% of anchors that are hot."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((b, a, 290), np.float32)
    pred[..., 0] = rng.uniform(40, 600, (b, a))
    pred[..., 1] = rng.uniform(40, 600, (b, a))
    pred[..., 2] = rng.uniform(20, 120, (b, a))
    pred[..., 3] = rng.uniform(10, 60, (b, a))
    pred[..., 4] = 1.0
    hot = rng.random((b, a)) < 0.015
    for s in [13, 44] + [68 + i * 37 for i in range(6)]:
        cls = rng.integers(0, 8, (b, a))
        pred[np.arange(b)[:, None], np.arange(a)[None, :], s + cls] = \
            np.where(hot, rng.uniform(0.5, 1.0, (b, a)), 0.02)
    return pred


def _spread(counts: torch.Tensor) -> dict:
    c = counts.double()
    return {"min": int(c.min()), "mean": float(c.mean()), "max": int(c.max())}


def main(argv=None):
    p = argparse.ArgumentParser("NMS stage bench (PyTorch/CUDA)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--anchors", type=int, default=8400)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--conf-thres", type=float, default=0.4)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--pre-nms-topk", type=int, default=512)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: batch 2, 1344 anchors (256 px), 2 steps (overrides those flags)")
    args = p.parse_args(argv)
    if args.small:
        args.batch_size, args.anchors, args.iters = 2, 1344, 2
    dev = resolve_device(args.device)

    from yololp_tpu_torch.ops.cuda_nms import greedy_nms_mask
    from yololp_tpu_torch.ops.cuda_nms_gate import nms_gate
    from yololp_tpu_torch.ops.nms import SELECTORS, non_max_suppression, select_candidates

    b, a, steps = args.batch_size, args.anchors, args.iters
    k = min(args.pre_nms_topk, a)
    x = torch.from_numpy(decode_traffic(b, a)).to(dev)

    def bench(fn, p0):
        @torch.no_grad()
        def prog(p, c0):
            c, total = c0, 0
            for _ in range(steps):
                p[..., 0].add_(c * 1e-6)
                out = fn(p)
                total = total + sum(t.float().sum() * 1e-9 for t in out)
                c = c + 1
            return total

        return timed_scan(prog, steps, p0, torch.zeros((), device=dev)) * 1e3

    def nms(iters):
        return lambda p_: non_max_suppression(
            p_, conf_thres=args.conf_thres, iou_thres=args.iou_thres, max_det=300,
            pre_nms_topk=k, nms_iters=iters)

    def candidates(p_):
        # both selectors: JAX's approx_max_k (taken when K < A) is an exact
        # sort off the TPU, as ops/nms.py:select_candidates says
        gated = nms_gate(p_, args.conf_thres)[1]
        top, idx = torch.sort(gated, dim=1, descending=True, stable=True)
        return top[:, :k], idx[:, :k]

    box_k, score_k, _ = select_candidates(x, args.conf_thres, k)
    keep = greedy_nms_mask(box_k, score_k, args.iou_thres)
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "batch": b, "anchors": a, "pre_nms_topk": k, "iters": steps,
           "conf_thres": args.conf_thres, "iou_thres": args.iou_thres,
           "candidates_per_image": _spread((score_k > 0).sum(1)),
           "kept_per_image": _spread(keep.sum(1))}
    # one program for both selectors off the TPU: one measurement each
    res["approx_timed_as"] = "topk"
    for iters in (0, 16):
        ms = bench(nms(iters), x)
        res.update({f"{sel}_iters{iters}_ms": ms for sel in SELECTORS})
    ms = bench(candidates, x)
    res.update({f"candidate_only_{sel}_ms": ms for sel in SELECTORS})
    # the keep-mask alone: the chain shifts the candidates' boxes instead
    res["greedy_nms_mask_ms"] = bench(lambda bx: (greedy_nms_mask(bx, score_k, args.iou_thres),),
                                      box_k.clone())
    if dev.type == "cuda":
        res["greedy_nms_kernel_device_ms"] = kernel_device_ms(
            lambda: greedy_nms_mask(box_k, score_k, args.iou_thres), "greedy_nms_kernel")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
