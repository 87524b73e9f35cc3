"""Run one cell of the benchmark of `yololp_tpu_torch` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (BENCHMARK.json's `workloads`) names a
configuration and a traffic mix; the mix's `kind` picks the driver
(benchmark/kinds/<kind>.py). One process: set-up (weights and inputs from
the seed, made on the card; warm-up of the cell's own shapes), then the
measured window, then (with --trace 1) a profiled slice, then the check
against the plain reference (the driver frees the program on the way). The last line of standard output is the
result as JSON; the numbers compared, each beside its limit, are the last
lines of standard error. Without a CUDA card, with fewer cards than the
cell asks for, or with JAX loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yololp_tpu")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def cache_env(root: Path):
    """Every compile cache at a fixed path inside the checkout (the port's
    nvcc builds go to build/kernels/ by themselves)."""
    base = root / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(base / "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(spec, cell_name, seed, seconds, want_trace, device, t0, overrides=None,
             card="not read"):
    """The cell's result dict (without printing). `overrides` ({"config":
    {...}, "traffic": {...}}) only serves the tests: small shapes on the CPU."""
    import numpy as np
    import torch

    from benchmark import check, spec as S
    from benchmark.flops import peaks

    cell = S.cell(spec, cell_name)
    ov = overrides or {}
    cfg = {**S.config(spec, cell["config"]), **ov.get("config", {})}
    traffic = {**S.traffic(cell["traffic"]), **ov.get("traffic", {})}
    drv = S.kind(traffic["kind"]).Driver(cfg, traffic, seed, device, log)
    drv.setup(want_trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    rec = drv.window(seconds)
    rec["setup_s"] = setup_s
    q = np.percentile(rec["latencies_s"], [50, 95, 99]) * 1e3
    log(f"window {rec['window_s']:.3f} s, {rec['units']} requests; ms a request: "
        f"median {q[0]:.3f}, p95 {q[1]:.3f}, p99 {q[2]:.3f}")
    if want_trace:
        rec["trace"] = drv.trace()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_check = time.perf_counter()
    numbers = drv.check(rec)
    log(f"the check took {time.perf_counter() - t_check:.3f} s (after the window, not in set-up)")
    ok, checks = check.judge(numbers, S.limits(cell_name))
    if rec.get("nms_work"):
        w = rec["nms_work"]
        log(f"counts: greedy NMS per launch {w['ops']:.0f} operations, {w['bytes']:.0f} bytes; "
            f"bounds against {peaks.FP32_FLOPS:.3g} FLOP/s fp32 and {peaks.HBM_BYTES:.3g} B/s "
            f"(card: {card})")

    metrics = {}
    for m in (S.per_layer(spec, cell_name) if want_trace else S.end_to_end(spec, cell_name)):
        v = S.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": rec["units"], "failed": 0,
              "metrics": metrics, "device": dev}
    if want_trace:
        tr = rec["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    cache_env(ROOT)
    from benchmark import spec as S

    spec = S.load(ROOT)
    cell = S.cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"refused: the cell needs {cell['chips']} CUDA card(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    card = power_limit()
    log(f"card: {card}")
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0, card=card)
    found = forbidden_modules()
    if found:
        log(f"refused: JAX-side modules loaded in this process: {found}")
        return 4
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
