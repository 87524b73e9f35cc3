"""The general serving driver (kinds/serve.py) on a configuration's true-int8
deployment: the same closed loop of one caller through the program's
`Inferer._run`, the same pool, window and profiled slice, with the Inferer
serving its int8 plan (`Inferer.use_int8`). Overridden: set-up (calibration
through the program's `quant.quantize.calibrate` on seeded frames drawn apart
from the pool, then the int8 plan, and its work from benchmark/flops/int8.py),
the gate, and the reference, check and control, which hold the program to the
plain int8 reference (reference/int8.py) on the reference's own calibration.

The reference's work in set-up (its calibration, and the fp32 and int8
reference decodes of every pooled batch that the gate reads) is timed apart:
its decodes are kept on the host for the check, which runs none again, and
its seconds are taken off `setup_s` (which run.py counts from the process's
start) when the check runs.

The check:
- the NMS stage, exactly, on the program's own decode (`nms_images_differ`);
- calibration: `amax_rel_err`, the largest |program - reference| / reference
  input amax over the calibrated convs, the reference calibrating on its
  forward with bf16-rounded convs, as the program calibrates its bf16 model;
- the plan: `plan_counts_differ`, how many of the program's own counters of
  one batch at set-up (`int8.convs`, int8 conv launches; `int8.quantized`,
  elements quantized from float) differ from the reference plan's counts;
- forward and decode: `int8_departure`, the served rows' mean gap to the
  plain int8 reference's rows (each paired with its nearest anchor,
  check.gaps), the reference on its own calibration, over that reference's
  own mean gap to the fp32 float reference: how far the served int8
  deployment, its calibration included, lies from the plain one, in units
  of int8's own error; and `conf_err_ratio` (check.compare): the served
  rows' mean confidence gap to the fp32 reference over the int8 reference's
  kept rows' gap. Another calibration moves the codes but not their
  precision, so the ratio stays near 1, where a per-tensor weight scale
  doubles it. Beside them (read, not judged) `box_err_ratio`, the same
  ratio of box gaps: its pairing with the nearest fp32 anchor saturates at
  int8's error (mean gaps up to 12 px at 640), so a control one precision
  below reads it on both sides of the program.

The control, in the program's place: the reference computed one precision
below, throughout: calibrated on a forward with fp8 convs, and with 6-bit
codes (qmax 31) in every int8 conv on that calibration.

Parameters (benchmark/traffic/<mix>.json): as kinds/serve.py, and
`calib_batches` batches of `calib_batch` frames for calibration. The
configuration's `int8` block names the plan (`conv_impl`; `chain_repblocks`,
`stage_handoffs` and `skip` as the Inferer serves them, or set-up refuses).
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import check
from benchmark.flops.int8 import int8_work
from benchmark.flops.nms import nms_work
from benchmark.kinds import serve
from benchmark.reference import int8 as ref_int8
from benchmark.reference import model as ref_model
from benchmark.reference import nms as ref_nms
from benchmark.weights import port_config, seeded_state_dict

CONTROL_QMAX = 31  # 6-bit codes


def rel_err(got: dict, want: dict) -> float:
    """The largest |got - want| / want over want's convs (infinite where got
    lacks one or has another)."""
    if set(got) != set(want):
        return float("inf")
    return max(abs(float(got[k]) - want[k]) / want[k] for k in want)


class Driver(serve.Driver):
    def setup(self, want_trace: bool):
        from yololp_tpu_torch.core.inferer import Inferer
        from yololp_tpu_torch.layers.fuse import fuse_state_dict
        from yololp_tpu_torch.quant.quantize import calibrate

        cfg, t, dev, q = self.cfg, self.t, self.device, self.cfg["int8"]
        self.skip = tuple(q["skip"])
        if not (q["chain_repblocks"] and q["stage_handoffs"]) or self.skip != ref_int8.SKIP:
            raise ValueError("the Inferer serves its int8 plan with chains, handoffs and the "
                             f"skip list {ref_int8.SKIP}; the configuration asks for {q}")
        self.sd = seeded_state_dict(cfg, self.seed, dev)
        v = cfg["vocab"]
        self.inferer = Inferer(None, fuse_state_dict(self.sd), port_config(cfg), img_size=self.size,
                               half=cfg["dtype"] == "bfloat16", conf_thres=1.0,
                               iou_thres=t["iou_thres"], max_det=t["max_det"], npro=v["npro"],
                               nalp=v["nalp"], nads=v["nads"], device=dev)
        self._make_pool()
        gen = torch.Generator(device=dev).manual_seed(self.seed + 2)
        self.calib = [torch.randint(0, 256, (t["calib_batch"], self.size, self.size, 3),
                                    dtype=torch.uint8, generator=gen, device=dev)
                      for _ in range(t["calib_batches"])]
        self.amax = calibrate(self.inferer.model, self.calib, method=q["calibration"]["method"],
                              skip_substrings=self.skip, device=dev)
        self.inferer.use_int8(self.amax, conv_impl=q["conv_impl"])
        self.work = int8_work(cfg, self.amax, self.size, self.size, t["batch"],
                              out_bytes=2 if cfg["dtype"] == "bfloat16" else 4)
        self.flops_per_image = self.work["float_flops"]
        self.log(f"counts: int8 plan {self.work['int8_ops']} operations and "
                 f"{self.flops_per_image} float FLOPs an image, {self.work['convs']} int8 conv "
                 f"launches a batch ({cfg['name']}, {self.size}x{self.size})")
        t_ref = time.perf_counter()
        self.ref_amax = ref_int8.calibrate(self.sd, cfg, self.calib, "bf16", self.skip)
        self.decodes, self.results = {}, {}
        self.gate = self._gate()
        self.ref_s = time.perf_counter() - t_ref
        self.inferer.conf_thres = self.gate
        self.log(f"gate {self.gate!r}; the reference's calibration and decodes {self.ref_s:.3f} s")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(t["warmup_rounds"]):
            for i in range(len(self.pool)):
                self._unit(i)
        self.plan_counts = self._plan_counts()
        self.split_ok = self._split_matches() if want_trace else None

    def _plan_counts(self) -> dict:
        """The program's own counters `int8.convs` and `int8.quantized` over
        one batch of `_run` (they record only while a profiler does), or {}
        where it keeps none. Its spans and counters are emptied after."""
        from yololp_tpu_torch.utils import profiler

        if not hasattr(profiler, "counters"):
            return {}
        profiler.reset_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            self.inferer._run(self.pool[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        c = profiler.counters()
        profiler.reset_spans()
        return {k: c.get(k, 0) for k in ("int8.convs", "int8.quantized")}

    def _decode(self, p, rounding=None, amax=None):
        """The reference's decode of pooled batch p: fp32 (None), or the int8
        plan on the table `amax` (the reference's own calibration by
        default) with 8-bit ("int8") or 6-bit ("int6") codes, its float
        layers in bf16."""
        b = self.pool[p].to(self.device)
        if rounding is None:
            return ref_model.decode_images(self.sd, self.cfg, b)
        qmax = ref_int8.QMAX if rounding == "int8" else CONTROL_QMAX
        return ref_int8.decode_images(self.sd, self.cfg, b,
                                      self.ref_amax if amax is None else amax, qmax, "bf16")

    def _gate(self):
        """For {"dense_anchors": n}: the lowest score at rank n of any image
        of any pooled batch, in the reference's fp32 decode and in the int8
        reference's, so that every served image passes at least about n
        anchors. The decodes are kept on the host for the check."""
        g = self.t["gate"]
        gate = float("inf") if isinstance(g, dict) else float(g)
        for p in range(len(self.pool)):
            for rounding in (None, "int8"):
                dec = self._decode(p, rounding)
                self.decodes[p, rounding] = dec.cpu()
                if isinstance(g, dict):
                    _, score = ref_nms.rows_of(dec, self.cfg["vocab"])
                    rank = min(int(g["dense_anchors"]), score.shape[1]) - 1
                    gate = min(gate, float(score.sort(1, descending=True).values[:, rank].min()))
                    del score
                del dec
        return gate

    @torch.no_grad()
    def reference(self, p, rounding=None, decode=None):
        """As serve.Driver.reference, on `decode`, or else on the reference's
        decode of pooled batch p kept from set-up (fp32 or "int8"; results
        kept for the control)."""
        if decode is not None:
            return super().reference(p, decode=decode)
        if (p, rounding) not in self.results:
            dec = self.decodes.pop((p, rounding)).to(self.device)
            self.results[p, rounding] = super().reference(p, decode=dec)
        return self.results[p, rounding]

    def _plan_differ(self) -> int:
        c, w = self.plan_counts, self.work
        if not c:
            return 2
        return int(c["int8.convs"] != w["convs"]) + int(
            c["int8.quantized"] != w["quantized"] * self.t["batch"])

    def _forward(self, rows) -> dict:
        """The forward's numbers of `rows` ({pooled batch: its rows per
        image}): check.compare against the fp32 reference beside the int8
        reference's kept rows, and `int8_departure`, their mean gap to the
        int8 reference's rows of every anchor over the int8 reference's own
        mean gap to the fp32 reference."""
        got, base, int8s, refs = [], [], [], []
        for p, r in rows.items():
            own = self.reference(p, "int8")
            got += r
            base += [x["rows"] for x in own]
            int8s += own
            refs += self.reference(p)
        apart = check.gaps(got, int8s)["box_err_mean_px"]
        return dict(check.compare(got, base, refs),
                    int8_departure=apart / check.gaps(base, refs)["box_err_mean_px"])

    def check(self, rec: dict) -> dict:
        """The NMS stage while the program is alive (serve.Driver's, on its
        own decode), the plan's counts, then with the program freed the
        calibration and the forward and decode. Puts the plan's work into
        `rec` for the per-layer readers, and takes the reference's seconds
        in set-up off its `setup_s`."""
        if "setup_s" in rec:
            rec["setup_s"] -= self.ref_s
            self.log(f"setup_s {rec['setup_s']:.3f} s, without the reference's {self.ref_s:.3f} s")
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
        rec["int8_work"] = dict(self.work, plan_counts=self.plan_counts)
        plan_differ = self._plan_differ()
        self._free()
        served = {p: check.served_rows(out) for p, out in enumerate(self.kept) if out is not None}
        return {**self._forward(served), "nms_images_differ": nms_differ,
                "amax_rel_err": rel_err(self.amax, self.ref_amax),
                "plan_counts_differ": plan_differ}

    def control(self) -> dict:
        """The control's numbers: the reference one precision below in the
        program's place, calibrated on fp8 convs and with 6-bit codes on
        that calibration, against the int8 and fp32 references."""
        amax = ref_int8.calibrate(self.sd, self.cfg, self.calib, "fp8", self.skip)
        rows = {p: [r["rows"] for r in self.reference(p, decode=self._decode(p, "int6", amax))]
                for p in range(len(self.pool))}
        return {**self._forward(rows), "amax_rel_err": rel_err(amax, self.ref_amax)}
