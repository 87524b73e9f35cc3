"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; each is
a data file of its own: benchmark/configs/<config>.json (the path that
BENCHMARK.json gives), benchmark/traffic/<traffic>.json (whose `kind` names
the general driver, benchmark/kinds/<kind>.py) and the limits of its
correctness check, benchmark/checks/<cell>.json. Every metric, end-to-end
or per-layer, has a reader of its own, benchmark/metrics/<metric>.py, with
`read(rec)` returning a number or None (nothing to read: the metric is left
out of the line).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str, here: Path = HERE) -> dict:
    return json.loads((here / "checks" / f"{cell_name}.json").read_text())


def kind(name: str):
    if not re.fullmatch(r"[A-Za-z_]\w*", name):
        raise ValueError(f"bad traffic kind {name!r}")
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(metric: str, here: Path = HERE):
    """The `read` function of benchmark/metrics/<metric>.py."""
    path = here / "metrics" / f"{metric}.py"
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", metric)
    s = importlib.util.spec_from_file_location(mod_name, path)
    if s is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def end_to_end(spec: dict, cell_name: str) -> list:
    """The end-to-end metrics this cell reports."""
    return [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(spec: dict, cell_name: str) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
