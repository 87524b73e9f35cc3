"""The port's measurement tools (yololp_tpu_torch/tools/) run on the CPU
when asked (`--device cpu --small`) and print the JSON of their JAX
counterparts, under the keys the port gives them. Times from the CPU are not
checked: they say nothing of the card.

timed_scan_delta2 raises when the 2K-step loop does not take 5% longer than
the K-step loop; at these tiny shapes host noise can trip that once, so the
tools' calls of it are retried up to 3 times here (the guard itself is
tested in tests/test_torch_profiler.py)."""

import json

import numpy as np
import pytest
import torch

from yololp_tpu_torch.tools import (bench_nms, probe_latency, probe_mxu_int8, probe_pallas_conv,
                                   profile_int8, profile_sections)
from yololp_tpu_torch.utils import profiler

torch.set_num_threads(2)


def last_json(text: str):
    """The last top-level JSON object printed (one line, or indented)."""
    lines = text.rstrip().splitlines()
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith("{"):
            try:
                return json.loads("\n".join(lines[i:]))
            except json.JSONDecodeError:
                continue
    raise AssertionError(f"no JSON object in the output:\n{text[-2000:]}")


@pytest.fixture
def retried_delta2(monkeypatch):
    def delta2(*args, **kw):
        for attempt in range(3):
            try:
                return profiler.timed_scan_delta2(*args, **kw)
            except RuntimeError:
                if attempt == 2:
                    raise
    for mod in (probe_mxu_int8, probe_pallas_conv, profile_int8):
        monkeypatch.setattr(mod, "timed_scan_delta2", delta2)


@pytest.fixture(scope="module")
def amax_json(tmp_path_factory):
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.quant.quantize import calibrate, save_amax

    inf = Inferer(".", None, "yololpn", img_size=64, half=False, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8)
    path = tmp_path_factory.mktemp("calib") / "amax.json"
    save_amax(calibrate(inf.model, [frames], device="cpu"), str(path))
    return str(path)


def positive(*values):
    return all(isinstance(v, float) and v > 0 for v in values)


def test_probe_mxu_int8(capsys, retried_delta2):
    probe_mxu_int8.main(["--device", "cpu", "--small", "--iters", "8"])
    out = last_json(capsys.readouterr().out)
    assert out["platform"] == "cpu"
    (row,) = out["matmul"]
    assert (row["M"], row["K"], row["library_bf16_out_dtype"]) == (256, 128, "bfloat16")
    assert positive(*(row[f"{r}_{k}"] for r in ("library", "kernel")
                      for k in ("bf16_tflops", "int8_tops", "int8_speedup")))
    (crow,) = out["conv3x3"]
    assert (crow["B"], crow["S"], crow["C"]) == (2, 16, 64)
    assert positive(crow["conv_bf16_tflops"], crow["conv_int8_tops"], crow["conv_int8_speedup"],
                    crow["c9dots_int8_tops"], crow["c9dots_vs_conv_bf16"])


def test_probe_pallas_conv(capsys, retried_delta2):
    probe_pallas_conv.main(["--device", "cpu", "--small", "--iters", "6"])
    out = last_json(capsys.readouterr().out)
    assert out["B"] == 2
    (row,) = out["rows"]
    assert (row["S"], row["C"]) == (16, 128)
    assert positive(row["bf16_tflops"], row["unfused_int8_tops"], row["kernel_int8_tops"],
                    row["kernel_vs_bf16"], row["kernel_vs_unfused"])


def test_profile_int8(capsys, retried_delta2, amax_json):
    profile_int8.main(["--device", "cpu", "--small", "--conf-file", "yololpn",
                       "--calib-pt", amax_json])
    out = last_json(capsys.readouterr().out)
    assert [(r["hw"], r["ch"]) for r in out["conv_rates"]] == [(16, 64), (8, 128), (4, 256),
                                                               (2, 512)]
    names = ["bf16"] + [g[0] for g in profile_int8.GRID]
    assert positive(*(out[f"{n}_ms"] for n in names), out["int8_best_vs_bf16"])


def test_probe_latency(capsys):
    probe_latency.main(["--device", "cpu", "--small", "--conf-file", "yololpn", "--int8"])
    out = last_json(capsys.readouterr().out)
    assert out["img_size"] == 64
    assert [(r["mode"], r["batch"]) for r in out["rows"]] == [
        ("bf16", 1), ("bf16", 2), ("int8", 1), ("int8", 2)]
    for r in out["rows"]:
        assert positive(r["ms_per_batch"], r["ms_per_img"], r["img_per_s"])


def test_profile_sections(capsys, amax_json):
    profile_sections.main(["--device", "cpu", "--small", "--conf-file", "yololpn",
                           "--calib-pt", amax_json, "--stages"])
    out = last_json(capsys.readouterr().out)
    cuts = ["..stem", "..ERBlock_2", "..ERBlock_3", "..ERBlock_4", "..ERBlock_5", "backbone",
            "backbone+neck", "full fwd", "e2e fwd+nms"]
    want = [f"{c} {t}" for t in ("bf16", "int8") for c in cuts] + ["nms alone"]
    assert [r["section"] for r in out["rows"]] == want
    assert all(positive(r["ms_per_batch"], r["img_per_s"]) for r in out["rows"])


def test_bench_nms(capsys):
    bench_nms.main(["--device", "cpu", "--small"])
    out = last_json(capsys.readouterr().out)
    assert (out["device"], out["batch"], out["anchors"], out["pre_nms_topk"]) == ("cpu", 2, 1344, 512)
    assert positive(out["topk_iters0_ms"], out["candidate_only_topk_ms"], out["greedy_nms_mask_ms"])
    # the conf gate leaves a zero tail; suppression keeps at most the candidates
    cand, kept = out["candidates_per_image"], out["kept_per_image"]
    assert 0 < cand["min"] <= cand["max"] < 512
    assert 0 < kept["min"] and kept["max"] <= cand["max"]
    assert not any(key.startswith("approx") or "iters16" in key for key in out)
