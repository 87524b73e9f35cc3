"""The harness on the CPU: every file that BENCHMARK.json names loads by
name; a new cell and metric load as new files alone; the traffic and the
weights are deterministic in the seed; a run's last line has the contract's
keys; the command refuses without a card."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run, spec as S  # noqa: E402
from benchmark.weights import seeded_state_dict  # noqa: E402

SPEC = S.load(ROOT)


CELLS = [w["name"] for w in SPEC["workloads"]]
SMALL = {"serve_dense": {"config": {"img_size": 128},
                         "traffic": {"batch": 2, "frame": [128, 128], "pool": 2, "trace_iters": 2,
                                     "warmup_rounds": 1}}}


def small(cell):
    return SMALL[S.cell(SPEC, cell)["traffic"]]


@pytest.fixture
def no_cuda_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_every_named_file_loads_by_name():
    spec = SPEC
    assert [c["name"] for c in spec["configs"]] and spec["workloads"]
    for c in spec["configs"]:
        assert S.config(spec, c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        assert S.kind(S.traffic(w["traffic"])["kind"]).Driver
        assert S.limits(w["name"])
        assert S.end_to_end(spec, w["name"]) and S.per_layer(spec, w["name"])
        assert "setup_s" in [m["name"] for m in S.end_to_end(spec, w["name"])]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(S.reader(m["name"]))


def test_a_new_cell_and_metric_load_as_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    (here / "traffic" / "serve_tiny.json").write_text(json.dumps(
        {**S.traffic("serve_dense"), "batch": 8, "pool": 2}))
    (here / "checks" / "yololps-b8-tiny.json").write_text(json.dumps({"conf_err_image": 0.01}))
    (here / "metrics" / "dummy_ms.serve.py").write_text("def read(rec):\n    return 1.5\n")
    spec["workloads"].append({"name": "yololps-b8-tiny", "config": "yololps",
                              "traffic": "serve_tiny", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "dummy_ms.serve", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "device", "moves": "images_per_s",
                              "workloads": ["yololps-b8-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # no file that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())
    spec = S.load(root)
    cell = S.cell(spec, "yololps-b8-tiny")
    assert S.config(spec, cell["config"], root)["name"] == "yololps"
    assert S.traffic(cell["traffic"], here)["batch"] == 8
    assert S.limits("yololps-b8-tiny", here) == {"conf_err_image": 0.01}
    assert [m["name"] for m in S.per_layer(spec, "yololps-b8-tiny")] == ["dummy_ms.serve"]
    assert S.reader("dummy_ms.serve", here)({}) == 1.5
    assert [m["name"] for m in S.end_to_end(spec, "yololps-b8-tiny")] == ["setup_s"]


def test_weights_are_deterministic_in_the_seed():
    cfg = {**S.config(SPEC, "yololps"), "img_size": 64}
    a = seeded_state_dict(cfg, 2**33 + 1, torch.device("cpu"))
    b = seeded_state_dict(cfg, 2**33 + 1, torch.device("cpu"))
    c = seeded_state_dict(cfg, 2**33 + 2, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a if a[k].is_floating_point())


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_deterministic_in_the_seed(cell, no_cuda_sync):
    ov = small(cell)
    spec_cell = S.cell(SPEC, cell)
    cfg = {**S.config(SPEC, spec_cell["config"]), **ov["config"]}
    tr = {**S.traffic(spec_cell["traffic"]), **ov["traffic"]}

    def pool_and_gate(seed):
        d = S.kind(tr["kind"]).Driver(cfg, tr, seed, torch.device("cpu"), lambda m: None)
        d.sd = seeded_state_dict(cfg, seed, d.device)
        d._make_pool()
        return [torch.as_tensor(p) for p in d.pool], d._gate()

    (p1, g1), (p2, g2), (p3, g3) = pool_and_gate(7), pool_and_gate(7), pool_and_gate(2**32 + 9)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2)) and g1 == g2
    assert not torch.equal(p1[0], p3[0]) and g1 != g3


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contract_keys(cell, trace, no_cuda_sync):
    r = run.run_cell(SPEC, cell, 2**31 + 3, 0.3, bool(trace), torch.device("cpu"),
                     time.perf_counter(), small(cell))
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(r) == keys + ["checks"]
    json.dumps(r)
    names = [m["name"] for m in (S.per_layer(SPEC, cell) if trace
                                 else S.end_to_end(SPEC, cell))]
    assert set(r["metrics"]) <= set(names)
    if not trace:
        assert set(r["metrics"]) == set(names)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["checks"]) == set(S.limits(cell))
    assert r["attempted"] > 0 and r["failed"] == 0


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "refused" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = SPEC["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "11",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
