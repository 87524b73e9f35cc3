"""Benchmark of the port: yololps throughput on one CUDA card (counterpart of
the repository's root bench.py, which measures the JAX package on a TPU).

    python -m yololp_tpu_torch.bench

Prints ONE JSON line with bench.py's keys, `vs_baseline` aside (bench.py
divides the headline by 625 img/s, a per-chip share of a TPU pod's target;
no such target exists for a card). Timing protocol, leg by leg:

  * headline: e2e bf16 inference (uint8 -> /255 -> fused forward -> 290-col
    decode -> NMS, whose keep-mask is csrc/greedy_nms.cu) at 640x640 b128: K
    = 20 chained steps, each on `images + c` (c a uint8 counter, wrapping),
    timed by CUDA events around one call after one warm call, on rolled
    operands (utils/profiler.timed_scan). A secondary per-batch-synced
    number: 6 distinct staged buffers, the first to warm up, the median
    host time of a call and a synchronize over the other 5;
  * true int8 inference: max-calibrated, the "conv" plan (every int8 conv in
    csrc/int8_conv.cu, handoffs between stages), built once, then the same
    chained protocol;
  * the train step (forward, ATSS, loss, backward, SGD, EMA under bf16
    autocast) at 640 b32 and b128: K chained steps, the state threaded
    through;
  * the native runner (deploy/aoti_cpp/) on end2end AOTInductor packages at
    b128, exported into build/bench/ at first use (bf16, and int8 on a max
    calibration), pipelined and synced;
  * the host JPEG decode + letterbox rate of the native batch decoder
    (data/native.py), where OpenCV's headers let it build; else no key,
    never the cv2 fallback's rate.

The bench measures only on a card: without one (or when the subprocess
probe of the card fails) it prints an error line with value null and exits
3.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from yololp_tpu_torch.core.inferer import Inferer, deploy_decode
from yololp_tpu_torch.core.train_step import init_train_state, make_train_step
from yololp_tpu_torch.data import native as native_decoder
from yololp_tpu_torch.deploy import aoti_cpp
from yololp_tpu_torch.export import export as export_mod
from yololp_tpu_torch.losses.loss import LossConfig
from yololp_tpu_torch.models.yolo import build_model
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.parallel.infer import infer_mesh, make_sharded_infer_fn
from yololp_tpu_torch.quant import int8_infer
from yololp_tpu_torch.quant.quantize import calibrate, model_device_dtype, save_amax
from yololp_tpu_torch.solver.build import SolverConfig
from yololp_tpu_torch.tools.profile_train import fake_batch
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.device import resolve_device
from yololp_tpu_torch.utils.profiler import timed_scan

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "build" / "bench"
# the inference legs' NMS (bench.py's); the int8 leg keeps the default top-K
NMS_KW = dict(conf_thres=0.4, iou_thres=0.45, max_det=300, pre_nms_topk=256)
INT8_NMS_KW = dict(conf_thres=0.4, iou_thres=0.45, max_det=300)
METRIC = "yololps 640x640 e2e inference (fwd+decode+NMS, bf16, b{batch}/card) "


def _contention_report():
    """Host load and live detached runs (pid files), reported beside the
    numbers so that a contended measurement is labelled, not mistaken for a
    regression."""
    info = {}
    try:
        info["load_1m"] = round(os.getloadavg()[0], 2)
    except OSError:
        pass
    live = []
    for pf in sorted(set(glob.glob(os.path.join(tempfile.gettempdir(), "*.pid"))
                         + glob.glob(str(ROOT / "runs" / "**" / "*.pid"), recursive=True))):
        try:
            with open(pf) as f:
                pid = int(f.read().split()[0])
            if pid == os.getpid():
                continue
            os.kill(pid, 0)  # liveness probe, no signal delivered
            live.append(f"{os.path.basename(pf)}:{pid}")
        except (OSError, ValueError, IndexError):
            continue
    if live:
        info["live_detached_runs"] = live
    return info


def _repo_affine(pid: int) -> bool:
    """The process's cwd lies in this checkout or its cmdline names it (or
    yololp)."""
    here = str(ROOT)
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            cmd = fh.read()
        cwd = os.readlink(f"/proc/{pid}/cwd")
    except OSError:
        return False
    return cwd.startswith(here) or here.encode() in cmd or b"yololp" in cmd.lower()


def _pause_detached_runs(live):
    """SIGSTOP the process groups of live detached runs (pid files only,
    never pattern matching) for the bench's duration; a detached watchdog
    SIGCONTs every paused group once this process exits, even if it is
    killed. Only python/bash processes of this checkout are paused: a
    recycled pid behind a stale pid file must not be frozen. Returns the
    paused pgids. Disable with YOLOLP_BENCH_NO_PAUSE=1."""
    if os.environ.get("YOLOLP_BENCH_NO_PAUSE") == "1" or not live:
        return []
    own_pgid = os.getpgid(0)
    paused = []
    for entry in live:
        pid = int(entry.rsplit(":", 1)[1])
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            if b"python" not in cmd and b"bash" not in cmd:
                continue
            pgid = os.getpgid(pid)
            if not _repo_affine(pid):
                # the pid file's leader may be a wrapper outside the checkout
                # whose child is the repository's work: scan its group
                members = []
                for d in os.listdir("/proc"):
                    if not d.isdigit():
                        continue
                    try:
                        if os.getpgid(int(d)) == pgid:
                            members.append(int(d))
                    except OSError:
                        continue
                if not any(_repo_affine(m) for m in members):
                    continue
            if pgid in (own_pgid, 0) or pgid in paused:
                continue
            os.killpg(pgid, signal.SIGSTOP)
            paused.append(pgid)
        except OSError:
            continue
    if paused:
        pgids = " ".join(str(p) for p in paused)
        script = (f"while kill -0 {os.getpid()} 2>/dev/null; do sleep 5; "
                  f"done; for g in {pgids}; do kill -CONT -$g 2>/dev/null; done")
        subprocess.Popen(["setsid", "bash", "-c", script], stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL)
    return paused


_PROBE = ("import torch; assert torch.cuda.is_available(), 'no CUDA card'; "
          "x = torch.ones((256, 256), dtype=torch.bfloat16, device='cuda'); "
          "(x @ x).sum().item()")


def _device_preflight():
    """Probe the card in bounded subprocess attempts before this process
    touches it, so that a wedged driver delays the bench instead of hanging
    it: a probe that times out is killed and retried until the budget
    (YOLOLP_BENCH_PREFLIGHT_S, default 1200 s) runs out. A probe that exits
    non-zero (no card, a broken driver) is not retried, and the bench
    refuses. Disable with YOLOLP_BENCH_NO_PREFLIGHT=1. Returns (report keys,
    device_ok)."""
    if os.environ.get("YOLOLP_BENCH_NO_PREFLIGHT") == "1":
        return {}, True
    budget_s = float(os.environ.get("YOLOLP_BENCH_PREFLIGHT_S", "1200"))
    t0 = time.time()
    timeouts = 0
    while True:
        left = budget_s - (time.time() - t0)
        if left <= 0:
            return {"preflight": f"device unresponsive through {timeouts} "
                                 f"probe timeouts / {int(budget_s)}s"}, False
        try:
            subprocess.run([sys.executable, "-c", _PROBE], timeout=min(150.0, max(30.0, left)),
                           check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            if timeouts:
                return {"preflight_recovered_after_s": int(time.time() - t0)}, True
            return {}, True
        except subprocess.TimeoutExpired:
            timeouts += 1
            print(f"bench preflight: device probe {timeouts} timed out "
                  f"({int(time.time() - t0)}s elapsed), retrying", file=sys.stderr, flush=True)
            time.sleep(min(20.0, max(0.0, budget_s - (time.time() - t0))))
        except subprocess.CalledProcessError as e:
            return {"preflight": f"probe exited rc={e.returncode}: no usable CUDA card"}, False


def _sync(devices):
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def _median_iter_time(step, staged_inputs, iters, devices):
    """Per-iteration sync, distinct inputs per iteration; median seconds."""
    times = []
    for i in range(iters):
        x = staged_inputs[i % len(staged_inputs)]
        t0 = time.perf_counter()
        step(*x)
        _sync(devices)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _pipelined_time(step, staged_inputs, iters, devices):
    """`iters` batches of distinct inputs launched back to back, one final
    synchronize; seconds a batch."""
    step(*staged_inputs[0])  # settle
    _sync(devices)
    t0 = time.perf_counter()
    for i in range(iters):
        step(*staged_inputs[i % len(staged_inputs)])
    _sync(devices)
    return (time.perf_counter() - t0) / iters


def e2e_fwd(model, device, nms_kw=NMS_KW):
    """fwd(images_u8) -> (det, num): /255 in the model's dtype, the fused
    deploy forward, the NMS at `nms_kw` (the bench's thresholds)."""
    dtype = model_device_dtype(model)[1]

    def fwd(images_u8):
        pred = deploy_decode(model, images_u8, device, dtype)
        det, _, num = non_max_suppression(pred.float(), **nms_kw)
        return det, num

    return fwd


def chained(fwd, iters):
    """scan_prog(images_u8, c0) -> the (iters,) values of `iters` steps,
    step i on `images_u8 + (c0 + i)` (uint8, wrapping), each value
    sum(det) * 1e-9 + sum(num): bench.py's lax.scan as a loop."""
    @torch.inference_mode()
    def scan_prog(images_u8, c0):
        vals, c = [], c0
        for _ in range(iters):
            det, num = fwd(images_u8 + c)
            vals.append(det.float().sum() * 1e-9 + num.sum())
            c = c + 1
        return torch.stack(vals)

    return scan_prog


def mesh_fwd(model, mesh):
    """(run, put) of the sharded e2e program over `mesh` (parallel/infer.py):
    run(chunks) -> (det, num) of the whole batch, on mesh[0]."""
    run3, put = make_sharded_infer_fn(model, mesh, **NMS_KW)

    def run(images_u8):
        det, _, num = run3(images_u8)
        return det, num

    return run, put


def _staged(rng, batch, img, device):
    return torch.from_numpy(rng.integers(0, 255, (batch, img, img, 3), np.uint8)).to(device)


def bench_inference(model, batch, img, iters=20, mesh=None, device="cuda"):
    """(chained img/s, per-batch-synced img/s) of the e2e program. With
    `mesh` (more than one visible card) the batch is sharded over it and
    both numbers are the aggregate; the sharded runner is timed by distinct
    staged buffers, pipelined, as bench.py times its mesh."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    if mesh is not None:
        run, put = mesh_fwd(model, mesh)
        staged = [(put(rng.integers(0, 255, (batch, img, img, 3), np.uint8)),)
                  for _ in range(4)]
        run(*staged[0])
        _sync(mesh)
        dt_sync = _median_iter_time(run, staged, iters, mesh)
        dt_pipe = _pipelined_time(run, staged, iters, mesh)
        return batch / dt_pipe, batch / dt_sync

    fwd = e2e_fwd(model, dev)
    x = _staged(rng, batch, img, dev)
    dt_scan = timed_scan(chained(fwd, iters), iters, x, torch.zeros((), dtype=torch.uint8,
                                                                    device=dev))
    run = torch.inference_mode()(fwd)
    staged = [(_staged(rng, batch, img, dev),) for _ in range(6)]
    run(*staged[0])
    _sync([dev])
    dt_sync = _median_iter_time(run, staged[1:], 5, [dev])
    return batch / dt_scan, batch / dt_sync


def int8_plan(model, state, amax, device="cuda"):
    """The int8 program, built once: the "conv" plan (every calibrated conv
    in csrc/int8_conv.cu, RepBlock chains, handoffs between stages) of the
    fused deploy `model` with kernels quantized from its fp32 deploy
    `state`. run(images_u8) -> (det, valid, num); a failure raises."""
    return int8_infer.make_int8_infer_fn(model, state, amax, conv_impl="conv",
                                         stage_handoffs=True, device=device, **INT8_NMS_KW)


def bench_int8(model, state, batch, img, iters=20, device="cuda"):
    """img/s of the int8 program by the chained protocol: calibrated (max)
    on 2 batches of 8 frames, the plan built once (int8_plan), no retry
    under another plan."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, 255, (8, img, img, 3), np.uint8) for _ in range(2)]
    run = int8_plan(model, state, calibrate(model, calib, method="max", device=dev), dev)

    def fwd(images_u8):
        det, _, num = run(images_u8)
        return det, num

    x = _staged(rng, batch, img, dev)
    dt = timed_scan(chained(fwd, iters), iters, x, torch.zeros((), dtype=torch.uint8, device=dev))
    return batch / dt


def train_program(model, batch, img, dtype=torch.bfloat16):
    """(state, train_step) of the train-graph `model`: ATSS, giou, the
    solver at epochs 10 x 100 steps, the forward under autocast in
    `dtype`."""
    state = init_train_state(model)
    step = make_train_step(model, LossConfig(img_size=(img, img), iou_type="giou"),
                           SolverConfig(epochs=10, steps_per_epoch=100), batch_size=batch,
                           dtype=dtype)
    return state, step


def train_scan(train_step, state, iters):
    """scan_prog(images, labels, mask, c0) -> the (iters,) totals of
    `iters` train steps, step i on `images + (c0 + i)`, the state threaded
    through."""
    def scan_prog(images, labels, mask, c0):
        totals, c = [], c0
        for _ in range(iters):
            _, total, _ = train_step(state, images + c, labels, mask)
            totals.append(total)
            c = c + 1
        return torch.stack(totals)

    return scan_prog


def bench_train_step(batch=32, img=640, iters=10, device="cuda"):
    """img/s of the yololps train step (seeded weights, bf16 autocast, fp32
    master weights) by K chained steps in one timed call: the card's rate
    of a training loop whose batches are on the card."""
    model = build_model(Config.named("yololps"), seed=0, device=device)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state, step = train_program(model, batch, img)
    images, labels, mask = (torch.from_numpy(a).to(dev)
                            for a in fake_batch(np.random.default_rng(2), batch, img))
    dt = timed_scan(train_scan(step, state, iters), iters, images, labels, mask,
                    torch.zeros((), dtype=torch.uint8, device=dev))
    return batch / dt


def bench_native_runner(package, batch=128, size=640, iters=20, timeout_s=1200):
    """The C++ runner (deploy/aoti_cpp/) on an end2end AOTInductor package:
    {images_per_sec (pipelined), sync_images_per_sec, fresh_buffers}. Raises
    when the package is absent or the runner fails."""
    if not Path(package).is_file():
        raise FileNotFoundError(f"no AOTInductor package at {package}")
    rec = aoti_cpp.bench(aoti_cpp.build_runner(), str(package), iters, batch, size,
                         timeout=timeout_s)
    return {"images_per_sec": float(rec["images_per_sec"]),
            "sync_images_per_sec": float(rec["sync"]["images_per_sec"]),
            "fresh_buffers": rec.get("fresh_buffers")}


def native_packages(batch=128, img=640):
    """{leg key: path} of the bench's AOTInductor packages in build/bench/."""
    return {key: BENCH_DIR / f"yololps_{kind}_{img}_b{batch}.aoti.pt2"
            for key, kind in (("native_int8", "int8"), ("native_bf16", "bf16"))}


def _ensure_native_artifacts(batch=128, img=640, device="cuda"):
    """Export the end2end packages the runner legs time, each only where it
    is absent: the seeded yololps, fused, bf16 (export/export.py with
    aoti=True); int8 on a max calibration of 2 batches of 4 frames from
    default_rng(1). The compile is set-up: its seconds go to stderr, beside
    the line. A failed export is printed there too; its runner leg then
    reports the absent package."""
    pkgs = native_packages(batch, img)
    calib = BENCH_DIR / f"yololps_bench_calib_{img}.json"
    for key, calib_pt in (("native_bf16", None), ("native_int8", calib)):
        if pkgs[key].is_file():
            continue
        t0 = time.perf_counter()
        try:
            if calib_pt is not None and not calib.is_file():
                model = Inferer(".", None, "yololps", img_size=img, half=True,
                                device=device).model
                rng = np.random.default_rng(1)
                frames = [rng.integers(0, 255, (4, img, img, 3), np.uint8) for _ in range(2)]
                save_amax(calibrate(model, frames, method="max", device=device), str(calib))
                del model
            export_mod.export_pt2("yololps", None, str(pkgs[key]).removesuffix(".aoti.pt2"),
                                  batch=batch, img_size=img, end2end=True, aoti=True,
                                  device=device,
                                  calib_pt=None if calib_pt is None else str(calib_pt))
            print(f"bench: exported {pkgs[key].name} in {time.perf_counter() - t0:.1f} s "
                  "(set-up, not timed)", file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 — the runner leg reports the absent package
            print(f"bench: exporting {pkgs[key].name} failed: {e}", file=sys.stderr, flush=True)
    torch.cuda.empty_cache()


def bench_preproc(n=256, size=640, src=(720, 1160), quality=90):
    """JPEG decode + letterbox img/s of the native batch decoder on this
    host, on synthetic high-entropy JPEGs at CCPD geometry (720x1160). None
    where the library cannot be the route (no OpenCV headers): the cv2
    fallback is never timed under this key. A failed build raises."""
    if not native_decoder.opencv_present():
        return None
    native_decoder.build()
    if not native_decoder.native_available():
        return None
    cv2 = native_decoder.require_cv2()

    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (src[0], src[1], 3), np.uint8)
    bufs = []
    for i in range(n):
        ok, enc = cv2.imencode(".jpg", np.roll(base, 7 * i + 1, axis=1),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if ok:
            bufs.append(enc.tobytes())
    native_decoder.decode_letterbox_batch(bufs[:8], size)  # warm the thread pool
    t0 = time.perf_counter()
    native_decoder.decode_letterbox_batch(bufs, size)
    return len(bufs) / (time.perf_counter() - t0)


def main():
    # elevated priority, so that niced background work cannot starve the
    # host's launches
    try:
        os.nice(-5)
    except (OSError, PermissionError):
        pass
    contention = _contention_report()
    paused = _pause_detached_runs(contention.get("live_detached_runs", []))
    if paused:
        contention["paused_pgids_during_bench"] = paused
        contention.pop("live_detached_runs", None)
        time.sleep(3)  # let in-flight device work of the paused runs drain
    preflight, device_ok = _device_preflight()
    contention.update(preflight)
    if not (device_ok and torch.cuda.is_available()):
        err = {"metric": METRIC.format(batch=128) + "per card", "value": None,
               "unit": "images/sec",
               "error": "no usable CUDA card (torch.cuda.is_available() is False or the "
                        "device probe failed); the bench measures only on a card"}
        err.update(contention)
        print(json.dumps(err))
        raise SystemExit(3)

    dev = torch.device("cuda")
    native = {}
    if os.environ.get("YOLOLP_BENCH_FAST") != "1":
        try:
            pp = bench_preproc()
            if pp is not None:
                native["preproc_images_per_sec"] = round(pp, 1)
        except Exception as e:  # noqa: BLE001 — host-side secondary metric
            native["preproc_error"] = str(e)[:200]
        _ensure_native_artifacts(device=dev)
        for key, pkg in native_packages().items():
            try:
                n_ips = bench_native_runner(pkg)
                native[f"{key}_images_per_sec"] = round(n_ips["images_per_sec"], 1)
                native[f"{key}_sync_images_per_sec"] = round(n_ips["sync_images_per_sec"], 1)
            except Exception as e:  # noqa: BLE001 — secondary metric
                native[f"{key}_error"] = str(e)[:200]

    batch, img = 128, 640
    inferer = Inferer(".", None, "yololps", img_size=img, half=True, device=dev)
    model, state = inferer.model, inferer.variables

    mesh = infer_mesh(device=dev)  # None on one card
    n_dev = len(mesh) if mesh is not None else 1
    ips, ips_sync = bench_inference(model, batch * n_dev, img, mesh=mesh, device=dev)
    result = {
        "metric": METRIC.format(batch=batch)
                  + (f"aggregate over {n_dev} cards" if n_dev > 1 else "per card"),
        "value": round(ips, 1),
        "unit": "images/sec",
        "per_batch_sync_images_per_sec": round(ips_sync, 1),
    }
    if n_dev > 1:
        result["n_devices"] = n_dev
        result["per_chip_images_per_sec"] = round(ips / n_dev, 1)
    if os.environ.get("YOLOLP_BENCH_FAST") != "1":
        try:
            result["int8_images_per_sec"] = round(bench_int8(model, state, batch, img,
                                                             device=dev), 1)
        except Exception as e:  # noqa: BLE001 — secondary metric
            result["int8_error"] = str(e)[:200]
        del inferer, model, state
        torch.cuda.empty_cache()
        try:
            tr_ips = bench_train_step(device=dev)
            result["train_images_per_sec_b32"] = round(tr_ips, 1)
            result["train_ms_per_step_b32"] = round(32e3 / tr_ips, 1)
        except Exception as e:  # noqa: BLE001
            result["train_error"] = str(e)[:200]
        torch.cuda.empty_cache()
        try:
            tr128 = bench_train_step(batch=128, iters=6, device=dev)
            result["train_images_per_sec_b128"] = round(tr128, 1)
            result["train_ms_per_step_b128"] = round(128e3 / tr128, 1)
        except Exception as e:  # noqa: BLE001
            result["train_b128_error"] = str(e)[:200]
        result["train_protocol"] = ("chained steps in one timed call (CUDA events), the "
                                    "batch on the card; the host enqueues each step")
    result.update(native)
    if "preproc_images_per_sec" in native:
        # a serving loop overlaps host decode with the card's inference, so
        # the decode-inclusive rate is the slower of the two stages
        result["e2e_decode_incl_images_per_sec"] = round(
            min(native["preproc_images_per_sec"], ips), 1)
        result["e2e_decode_incl_note"] = "min(host JPEG decode+letterbox, device e2e)"
    result.update(contention)
    post = _contention_report()
    if post.get("load_1m", 0) > contention.get("load_1m", 0) + 1:
        result["load_1m_post"] = post["load_1m"]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
