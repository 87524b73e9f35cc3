"""The general serving driver (kinds/serve.py) on the P6 configurations: the
same closed loop of one caller through the program's `Inferer._run`, the
same pool, window, profiled slice, check and control, with the P6 plain
reference (reference/p6.py), its FLOP count (flops/p6.py) and its seeded
weights (weights_p6.py) in place of the P5 ones. Only what names the
reference is overridden: set-up, the gate and the reference decode. The
gate is taken over every pooled batch and both of the reference's
precisions, not over the first batch's fp32 decode alone.

Parameters (benchmark/traffic/<mix>.json): as kinds/serve.py.
"""

from __future__ import annotations

import gc

import torch

from benchmark.flops.p6 import forward_flops
from benchmark.kinds import serve
from benchmark.reference import nms as ref_nms
from benchmark.reference import p6 as ref_p6
from benchmark.weights import port_config
from benchmark.weights_p6 import seeded_state_dict


class Driver(serve.Driver):
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

    def _gate(self):
        """For {"dense_anchors": n}: the lowest score at rank n of any image
        of any pooled batch, in the reference's fp32 decode and in its decode
        with bf16-rounded convs, so that every served image, whose scores
        the bf16 forward rounds, passes at least about n anchors."""
        g = self.t["gate"]
        if not isinstance(g, dict):
            return float(g)
        gate = float("inf")
        for b in self.pool:
            for rounding in (None, "bf16"):
                dec = ref_p6.decode_images(self.sd, self.cfg, b.to(self.device), rounding)
                _, score = ref_nms.rows_of(dec, self.cfg["vocab"])
                rank = min(int(g["dense_anchors"]), score.shape[1]) - 1
                gate = min(gate, float(score.sort(1, descending=True).values[:, rank].min()))
                del dec, score
        return gate

    @torch.no_grad()
    def reference(self, p, rounding=None, decode=None):
        """As serve.Driver.reference, on the P6 reference's decode."""
        if decode is None:
            decode = ref_p6.decode_images(self.sd, self.cfg, self.pool[p].to(self.device),
                                          rounding)
        return super().reference(p, decode=decode)
