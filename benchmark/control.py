"""Readings from which a cell's check limits are set, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 ... [--seconds 3]

For each seed, in one process: the cell's set-up and a short window of the
program at the cell's own load, then the check's numbers of the program
against the reference (the lower readings; the NMS stage's exact count
with them), then the control: the reference computed with fp8 (e4m3,
per-tensor scales) inputs and weights in every conv, one precision below
the served bf16, put in the program's place on the same inputs (the upper
readings of the forward's numbers). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run, spec as S

    run.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 3
    spec = S.load(ROOT)
    cell = S.cell(spec, args.workload)
    cfg = S.config(spec, cell["config"])
    traffic = S.traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        drv = S.kind(traffic["kind"]).Driver(cfg, traffic, seed, dev, run.log)
        drv.setup(False)
        rec = drv.window(args.seconds)
        line = {"workload": args.workload, "seed": seed, "units": rec["units"],
                "program": drv.check(rec), "control": drv.control(),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del drv
    return 0


if __name__ == "__main__":
    sys.exit(main())
