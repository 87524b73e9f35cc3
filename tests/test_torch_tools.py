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

from yololp_tpu_torch.tools import (bench_nms, probe_int8_e2e, probe_latency, probe_mxu_int8,
                                   probe_pallas_conv, probe_train_mfu, profile_int8,
                                   profile_sections, profile_train)
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
    for mod in (probe_mxu_int8, probe_pallas_conv, profile_int8, probe_int8_e2e):
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
    want = [f"{c} {t}" for t in ("bf16", "int8") for c in cuts] + [
        "nms alone (nms_iters=0)", "nms alone (nms_iters=16)"]
    assert [r["section"] for r in out["rows"]] == want
    assert all(positive(r["ms_per_batch"], r["img_per_s"]) for r in out["rows"])


def test_bench_nms(capsys):
    bench_nms.main(["--device", "cpu", "--small"])
    out = last_json(capsys.readouterr().out)
    assert (out["device"], out["batch"], out["anchors"], out["pre_nms_topk"]) == ("cpu", 2, 1344, 512)
    # the JAX tool's grid: each selector with each keep-mask, and each
    # selector alone
    grid = [f"{s}_iters{n}_ms" for s in ("topk", "approx") for n in (0, 16)]
    assert positive(*(out[key] for key in grid), out["candidate_only_topk_ms"],
                    out["candidate_only_approx_ms"], out["greedy_nms_mask_ms"])
    # off the TPU the selectors run one program, timed once
    assert out["approx_timed_as"] == "topk"
    assert [out[f"approx_iters{n}_ms"] for n in (0, 16)] == [out[f"topk_iters{n}_ms"]
                                                             for n in (0, 16)]
    assert out["candidate_only_approx_ms"] == out["candidate_only_topk_ms"]
    # the conf gate leaves a zero tail; suppression keeps at most the candidates
    cand, kept = out["candidates_per_image"], out["kept_per_image"]
    assert 0 < cand["min"] <= cand["max"] < 512
    assert 0 < kept["min"] and kept["max"] <= cand["max"]


def _self_label(path, det, size):
    """Write the label file of the image at `path` from its detections `det`
    (n, 28), clipped to the frame: classes, normalized cxcywh, corners."""
    box = np.clip(det[:, :4], 0, size) / size
    cors = np.clip(det[:, 4:12], 0, size) / size
    keep = (box[:, 2] - box[:, 0] > 1e-3) & (box[:, 3] - box[:, 1] > 1e-3)
    rows = np.concatenate([det[:, 20:28], (box[:, :2] + box[:, 2:]) / 2, box[:, 2:] - box[:, :2],
                           cors], 1)[keep]
    label = path.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt"
    with open(label, "w") as f:
        for r in rows:
            f.write(" ".join([str(int(v)) for v in r[:8]] + [f"{v:.6f}" for v in r[8:]]) + "\n")


def test_sensitivity_cli_writes_its_json(tmp_path, monkeypatch):
    """`tools.sensitivity` against the JAX tool (tools/sensitivity.py) at
    64 px on 4 synthetic val frames, both in fp32, on one yololpn checkpoint
    the port writes (every weight drawn from a seed). The frames are labelled
    with that float model's own detections, so the baseline mAP is above 0
    and quantizing a conv moves it. The amax file holds 4 of the model's 70
    convs, one from each part of the graph (the tool ranks the convs its file
    names), so the run stays short: baseline, fully quantized and each
    conv's drop are equal. (Across all 70 convs every single-conv drop is
    equal too; the fully quantized mAP of 70 convs is not, for the reason
    given in tests/test_torch_quant.py:test_quantized_apply_matches_jax.)"""
    import jax.numpy as jnp

    import yololp_tpu.models as jmodels
    from test_torch_zoo import random_jax_variables
    from tools import sensitivity as jsensitivity
    from yololp_tpu_torch.core.evaler import Evaler
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.data.synthetic import make_synthetic_dataset
    from yololp_tpu_torch.models.yolo import Model
    from yololp_tpu_torch.quant.quantize import calibrate, save_amax
    from yololp_tpu_torch.tools import sensitivity
    from yololp_tpu_torch.utils.checkpoint import save_checkpoint
    from yololp_tpu_torch.utils.config import Config

    ckpt, data = str(tmp_path / "w.msgpack"), str(tmp_path / "data")
    save_checkpoint({"format": "train",
                     "variables": random_jax_variables(Model(Config.named("yololpn")), 7)}, ckpt)
    make_synthetic_dataset(data, n_train=1, n_val=4, img_size=64, seed=0)
    inf = Inferer(None, ckpt, "yololpn", img_size=64, half=False, device="cpu")
    ev = Evaler({"val": str(tmp_path / "data" / "images" / "val")}, 2, 64, workers=0,
                device="cpu")
    batches = list(ev.init_data("val")[0])
    preds, _ = ev.predict(ev.make_infer_fn(inf.model), batches)
    for path, det in zip(ev.last_paths, preds):
        _self_label(path, det, 64)
    amax = calibrate(inf.model, [np.concatenate([b[0] for b in batches])], device="cpu")
    assert len(amax) == 70
    some = {k: amax[k] for k in sorted(amax)[::23]}
    save_amax(some, str(tmp_path / "amax4.json"))

    args = ["--conf-file", "yololpn", "--weights", ckpt, "--synthetic-data", data,
            "--calib-pt", str(tmp_path / "amax4.json"), "--img-size", "64", "--batch-size", "2",
            "--max-images", "4", "--device", "cpu"]
    ranked = sensitivity.main(args + ["--out", str(tmp_path / "sens.json")])
    # the JAX tool's model in fp32, as the port's on the CPU (it runs bf16)
    jmodel = jmodels.Model
    monkeypatch.setattr(jmodels, "Model", lambda **kw: jmodel(**{**kw, "dtype": jnp.float32}))
    jsensitivity.main(args + ["--out", str(tmp_path / "jax.json")])
    res = json.loads((tmp_path / "sens.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert set(res) == {"baseline_mAP", "full_quant_mAP", "drops"}
    assert set(res["drops"]) == set(some) and len(ranked) == 4
    drops = list(res["drops"].values())
    assert drops == sorted(drops, reverse=True)
    assert res == want
    assert res["baseline_mAP"] > 0 and any(d != 0 for d in drops)


def test_pipeline_stage_configs_match_jax(tmp_path):
    """The stage configs the port's pipeline writes load to the JAX
    pipeline's (from the port's configs/repopt), and the eval log parser and
    the distill table read what the port's CLIs print."""
    from tools import repopt_qat_pipeline as jpipe
    from yololp_tpu.utils.config import Config as JConfig
    from yololp_tpu_torch.tools import distill_proof, repopt_qat_pipeline as tpipe
    from yololp_tpu_torch.tools.eval import print_report
    from yololp_tpu_torch.utils.config import Config

    hs, amax = str(tmp_path / "hs.msgpack"), str(tmp_path / "amax.json")
    got = tpipe.stage_configs(str(tmp_path / "t"), "yolov6s", hs, amax)
    want = (jpipe.write_stage_cfg(str(tmp_path / "j"), "hs", "yolov6s_hs.py"),
            jpipe.write_stage_cfg(str(tmp_path / "j"), "opt", "yolov6s_opt.py",
                                  f"scales = {hs!r}\n"),
            jpipe.write_stage_cfg(str(tmp_path / "j"), "qat", "yolov6s_opt_qat.py",
                                  f"scales = {hs!r}\nqat = dict(calib_pt={amax!r}, "
                                  "sensitive_layers_skip=False,\n           "
                                  "sensitive_layers_list=[])\n"))
    for g, w in zip(got, want):
        assert g.startswith(str(tmp_path / "t" / "configs"))
        gc, wc = Config.fromfile(g), JConfig.fromfile(w)
        assert {k: v for k, v in gc.items() if k != "_filename"} == \
            {k: v for k, v in wc.items() if k != "_filename"}
    opt = Config.fromfile(got[1])
    assert opt["scales"] == hs and opt["training_mode"] == "repopt"
    assert all(float(v) == 0.0 for v in opt["data_aug"].values())
    assert Config.fromfile(got[2])["qat"]["calib_pt"] == amax

    log = tmp_path / "eval.log"
    with open(log, "w") as f:
        import contextlib

        with contextlib.redirect_stdout(f):
            print_report((0.5, 0.75, 0.25, 0.4, 0.9, [0.5] * 10, [0.9] * 10),
                         {"pre_ms": 1.0, "infer_ms": 2.0, "post_ms": 0.5})
    want_row = {"mAP": 0.5, "mAP50": 0.75, "mAP75": 0.25, "mAP50_95": 0.4, "recall": 0.9}
    assert tpipe.parse_eval(str(log)) == jpipe.parse_eval(str(log)) == want_row

    train_log = tmp_path / "train_log.jsonl"
    train_log.write_text('{"epoch": 0, "val/mAP": 0.1}\nnot json\n{"epoch": 3, "val/mAP": 0.3}\n')
    best = distill_proof.best_val_from_log(str(train_log))
    assert best == {"epoch": 3, "val/mAP": 0.3}
    args = distill_proof.argparse.Namespace(student_conf="s.py", teacher_ckpt="t.msgpack",
                                            data="d.yaml", img_size=64, batch_size=2, epochs=1,
                                            seed=0)
    rows = {"baseline": {**want_row, "train_best": None},
            "distill": {**want_row, "mAP": 0.6, "train_best": best}}
    lines = distill_proof.results_lines(args, rows)
    assert lines[0] == "# LP distillation proof" and "0.3000 @e3" in lines[-3]
    assert lines[-1] == "distill - baseline mAP delta: +0.1000"


def jax_conv_flops(jaxpr) -> float:
    """Flops of the convolutions and matmuls of a jaxpr, 2 a multiply-add,
    the holes of a dilated input not counted (torch's FlopCounterMode
    counts a transposed conv and a strided conv's input gradient so)."""
    from jax.extend import core

    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec  # (out, in, spatial...)
            window = np.prod([rhs[d] for d in spec[2:]])
            total += (2 * np.prod(eqn.outvars[0].aval.shape) * window * rhs[spec[1]]
                      / np.prod(eqn.params["lhs_dilation"]))
        elif eqn.primitive.name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * np.prod(eqn.outvars[0].aval.shape) * np.prod([lhs[d] for d in contract])
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, (core.ClosedJaxpr, core.Jaxpr)):
                    total += jax_conv_flops(getattr(sub, "jaxpr", sub))
    return total


def test_profile_train(capsys):
    """Every part is timed; the flops of fwd and fwd_bwd equal those of the
    JAX tool's programs (its model.apply(train=True) and the gradient of
    the outputs' sum w.r.t. the parameters), counted from their jaxprs."""
    import jax
    import jax.numpy as jnp

    import conftest  # noqa: F401  (forces the JAX cpu backend)
    from yololp_tpu.models import Model as JModel
    from yololp_tpu.utils.config import Config as JConfig
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.convert import state_dict_to_jax

    profile_train.main(["--device", "cpu", "--small", "--conf-file", "yololpn"])
    out = last_json(capsys.readouterr().out)
    assert (out["platform"], out["batch"], out["img"]) == ("cpu", 2, 64)
    parts = ("full", "fwd", "fwd_bwd", "loss_fwd", "loss_grad", "opt")
    assert positive(*(out[f"{p}_ms"] for p in parts))
    assert isinstance(out["unattributed_ms"], float)

    model = JModel(config=JConfig.named("yololpn"), deploy=False, dtype=jnp.bfloat16)
    # the flax tree of the same model (utils/convert.py), without flax's init
    variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_jax(
        build_model(Config.named("yololpn"), device="cpu").state_dict()))
    x = jnp.zeros((2, 64, 64, 3), jnp.bfloat16)

    def fwd(params):
        return model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                           train=True, mutable=["batch_stats"])[0]

    def out_sum(params):
        return sum(jnp.sum(t.astype(jnp.float32)) for t in jax.tree_util.tree_leaves(fwd(params)))

    for name, fn in (("fwd", fwd), ("fwd_bwd", jax.grad(out_sum))):
        want = jax_conv_flops(jax.make_jaxpr(fn)(variables["params"]).jaxpr)
        assert out[f"{name}_flops"] == want, name
    # the full step's convs are the forward's and backward's; the loss has none
    assert out["full_flops"] == out["fwd_bwd_flops"] > 2.9 * out["fwd_flops"]


def test_probe_train_mfu(capsys):
    probe_train_mfu.main(["--device", "cpu", "--small", "--conf-file", "yololpn"])
    out = last_json(capsys.readouterr().out)
    assert out["platform"] == "cpu"
    assert [(r["batch"], r["img"], r["variant"]) for r in out["rows"]] == [
        (b, 64, v) for b in (1, 2) for v in ("infer_fwd", "train_fwd", "fwd_bwd")]
    for r in out["rows"]:
        assert positive(r["ms"], r["tflop"], r["tflop_per_s"])
        assert r["mfu_pct_bf16_peak"] is None  # no share of the card's peak from a CPU run
    by = {(r["batch"], r["variant"]): r["tflop"] for r in out["rows"]}
    assert by[(2, "infer_fwd")] == by[(2, "train_fwd")] == 2 * by[(1, "train_fwd")]


def test_probe_int8_e2e(capsys, retried_delta2, amax_json):
    probe_int8_e2e.main(["--device", "cpu", "--small", "--conf-file", "yololpn",
                         "--calib-pt", amax_json])
    out = last_json(capsys.readouterr().out)
    names = (["bf16"] + [c[0] for c in probe_int8_e2e.CUTS]
             + ["bf16_nms", "int8_full_nms", "chain_bf16", "chain_int8"])
    assert positive(*(out[f"{n}_ms"] for n in names))
