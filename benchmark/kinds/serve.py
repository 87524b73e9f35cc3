"""The general serving driver: a closed loop of one caller through the
program's `Inferer._run`, from a traffic file's parameters.

Each request is one batch of letterboxed RGB uint8 frames (`batch` x
`frame`) sent from pinned host memory through `Inferer._run`, whose det,
valid and num are copied back to the host before the next is sent.

Parameters (benchmark/traffic/<mix>.json):
- `pool`: distinct batches, made on the card from the seed and cycled in
  order.
- `gate`: a number, or {"dense_anchors": n}: the largest score that n
  anchors of every image of the first batch reach in the reference's fp32
  decode, so the NMS walks a full top-K.
- `iou_thres`, `max_det`, `pre_nms_topk`: the NMS. The program takes the
  first two from the Inferer; the reference takes all three, so a program
  that cuts at another top-K reads incorrect.
- `warmup_rounds`, `trace_iters`: warm-up passes over the pool; batches in
  the profiled slice.

Each pooled batch's window output is kept once (the occurrence drawn from
the seed) for the check after the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, trace
from benchmark.flops.model import forward_flops
from benchmark.flops.nms import nms_work
from benchmark.reference import model as ref_model
from benchmark.reference import nms as ref_nms
from benchmark.weights import port_config, seeded_state_dict


class Driver:
    def __init__(self, cfg, traffic, seed, device, log):
        self.cfg, self.t, self.seed, self.device, self.log = cfg, traffic, seed, device, log
        self.size = int(cfg["img_size"])
        self.rng = np.random.default_rng(seed)

    # -- set-up -----------------------------------------------------------
    def setup(self, want_trace: bool):
        from yololp_tpu_torch.core.inferer import Inferer
        from yololp_tpu_torch.layers.fuse import fuse_state_dict

        cfg, t, dev = self.cfg, self.t, self.device
        self.flops_per_image = forward_flops(cfg, self.size, self.size)
        self.log(f"counts: fused forward {self.flops_per_image} FLOPs an image "
                 f"({cfg['name']}, {self.size}x{self.size})")
        self.sd = seeded_state_dict(cfg, self.seed, dev)
        v = cfg["vocab"]
        self.inferer = Inferer(None, fuse_state_dict(self.sd), port_config(cfg), img_size=self.size,
                               half=cfg["dtype"] == "bfloat16", conf_thres=1.0,
                               iou_thres=t["iou_thres"], max_det=t["max_det"], npro=v["npro"],
                               nalp=v["nalp"], nads=v["nads"], device=dev)
        self._make_pool()
        self.gate = self._gate()
        self.inferer.conf_thres = self.gate
        self.log(f"gate {self.gate!r}")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(t["warmup_rounds"]):
            for i in range(len(self.pool)):
                self._unit(i)
        self.split_ok = self._split_matches() if want_trace else None

    def _make_pool(self):
        t, dev = self.t, self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        h, w = t["frame"]
        if (h, w) != (self.size, self.size):
            raise ValueError(f"the serving driver takes letterboxed {self.size}x{self.size} frames")
        frames = torch.randint(0, 256, (t["pool"], t["batch"], h, w, 3), dtype=torch.uint8,
                               generator=gen, device=dev).cpu()
        self.pool = [b.pin_memory() if dev.type == "cuda" else b.clone() for b in frames]
        self.kept = [None] * len(self.pool)  # the sampled output of each pooled batch
        self.seen = [0] * len(self.pool)

    def _gate(self):
        g = self.t["gate"]
        if not isinstance(g, dict):
            return float(g)
        dec = ref_model.decode_images(self.sd, self.cfg, self.pool[0].to(self.device))
        _, score = ref_nms.rows_of(dec, self.cfg["vocab"])
        rank = min(int(g["dense_anchors"]), score.shape[1]) - 1
        gate = float(score.sort(1, descending=True).values[:, rank].min())
        del dec, score
        return gate

    def _split_matches(self):
        """Whether `predict` then `non_max_suppression` with the Inferer's
        thresholds gives `_run`'s outputs bit for bit (the traced slice
        times the two halves apart)."""
        b = self.pool[0]
        whole = self.inferer._run(b)
        halves = self._halves(b)
        return all(torch.equal(a, c) for a, c in zip(whole, halves))

    def _halves(self, b):
        from yololp_tpu_torch.ops.nms import non_max_suppression

        inf = self.inferer
        with torch.inference_mode():
            with record_function("bench.predict"):
                pred = inf.predict(b)
            with record_function("bench.nms"):
                return non_max_suppression(pred, conf_thres=inf.conf_thres, iou_thres=inf.iou_thres,
                                           max_det=inf.max_det, candidate_selector=inf.nms_selector)

    # -- the loop ---------------------------------------------------------
    def _unit(self, i, split=False):
        """One request: batch `i % pool` through the served path."""
        p = i % len(self.pool)
        out = self._halves(self.pool[p]) if split else self.inferer._run(self.pool[p])
        with record_function("bench.readback"):
            return p, tuple(o.cpu() for o in out)

    def _keep(self, p, out):
        """Reservoir of one per pooled batch, drawn from the seed."""
        self.seen[p] += 1
        if self.rng.integers(0, self.seen[p]) == 0:
            self.kept[p] = out

    def window(self, seconds: float) -> dict:
        lat, i = [], 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            p, out = self._unit(i)
            now = time.perf_counter()
            lat.append(now - ts)
            self._keep(p, out)
            i += 1
            if now - t0 >= seconds:
                break
        return dict(units=i, images=i * self.t["batch"], batch=self.t["batch"], window_s=now - t0,
                    latencies_s=lat, flops_per_image=self.flops_per_image)

    def trace(self) -> dict:
        out = {}
        n = int(self.t["trace_iters"])
        with trace.profiled(out):
            for i in range(n):
                with record_function("bench.request"):
                    self._unit(i, split=bool(self.split_ok))
        out.update(iters=n, split_ok=self.split_ok)
        return out

    # -- after the window -------------------------------------------------
    def _free(self):
        del self.inferer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def reference(self, p, rounding=None, decode=None):
        """The reference NMS of pooled batch p, per image a dict (reference/
        nms.py) with `all_rows`, the row of every anchor, beside it: on the
        reference's own decode (fp32, or with bf16- or fp8-rounded convs), or
        on `decode`."""
        t = self.t
        dec = (ref_model.decode_images(self.sd, self.cfg, self.pool[p].to(self.device), rounding)
               if decode is None else decode)
        all_rows, _ = ref_nms.rows_of(dec, self.cfg["vocab"])
        res = ref_nms.nms(dec, self.cfg["vocab"], self.gate, t["iou_thres"], t["max_det"],
                          t["pre_nms_topk"])
        for r, rows in zip(res, all_rows):
            r["all_rows"] = rows
        return res

    def check(self, rec: dict) -> dict:
        """The check's numbers over every pooled batch's sampled output, and
        the NMS work per launch (for the roofline) into `rec`. The program is
        freed on the way.

        First, while the program is alive, the NMS stage: the reference NMS
        of the program's own decode (`Inferer.predict` of the same batch)
        against the served det, valid and num. Then, with the program freed,
        the forward and decode: the served rows against the reference's
        fp32 decode of every anchor, beside the bf16-rounded reference's own
        kept rows (check.compare)."""
        nms_differ, works = 0, []
        for p, out in enumerate(self.kept):
            if out is None:
                continue
            with torch.inference_mode():
                dec = self.inferer.predict(self.pool[p])
            res = self.reference(p, decode=dec)
            del dec
            nms_differ += check.nms_differ(out, res)
            works.append(nms_work([r["keep"] for r in res], [r["n_valid"] for r in res]))
        rec["nms_work"] = dict(ops=sum(w[0] for w in works) / len(works),
                               bytes=sum(w[1] for w in works) / len(works)) if works else None
        self._free()

        served, base, refs = [], [], []
        for p, out in enumerate(self.kept):
            if out is not None:
                served += check.served_rows(out)
                base += [r["rows"] for r in self.reference(p, "bf16")]
                refs += self.reference(p)
        return {**check.compare(served, base, refs), "nms_images_differ": nms_differ}

    def control(self) -> dict:
        """The control's numbers: the reference in fp8 in the program's
        place, on the same pooled batches, against the fp32 reference."""
        served, base, refs = [], [], []
        for p in range(len(self.pool)):
            served += [r["rows"] for r in self.reference(p, "fp8")]
            base += [r["rows"] for r in self.reference(p, "bf16")]
            refs += self.reference(p)
        return check.compare(served, base, refs)
