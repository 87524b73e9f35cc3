"""The port stands alone: no module of yololp_tpu_torch/ (export/ and
deploy/ included), and not chip_smoke.py, imports jax, flax or the JAX
package (cv2, msgpack, yaml and PIL only inside functions), and every entry
point refuses to fall back to the CPU when no GPU is present; the trainer
refuses a mesh that is not its process group."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yololp_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "yololp_tpu"}
# msgpack and yaml are absent on the machine with the card (cv2 and PIL may
# be there, OpenCV's headers are not): all four imported lazily only
LAZY = {"cv2", "msgpack", "yaml", "PIL"}


def port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def port_modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name.split(".")[0], node) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    assert (ROOT / "chip_smoke.py").is_file()
    for path in port_files():
        tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
        top_level = set(tree.body)
        for root, node in imported_roots(tree):
            assert root not in FORBIDDEN, f"{path.relative_to(ROOT)}:{node.lineno} imports {root}"
            if root in LAZY:
                assert node not in top_level, (
                    f"{path.relative_to(ROOT)}:{node.lineno} imports {root} at module level")


def test_every_port_module_imports_without_jax_cv2_or_msgpack():
    blocked = ", ".join(f"{m!r}: None" for m in sorted(FORBIDDEN | LAZY))
    code = (f"import importlib, sys\nsys.modules.update({{{blocked}}})\n"
            f"for m in {port_modules()!r}:\n    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.tools.infer import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Inferer(str(tmp_path), None, "yololpn", img_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--source", str(tmp_path), "--conf-file", "yololpn", "--not-save-img"])
    # the CPU is taken only when asked for, and then runs the plain NMS
    inf = Inferer(str(tmp_path), None, "yololpn", img_size=64, half=False, device="cpu")
    assert len(inf.detect_batch([np.zeros((64, 64, 3), np.uint8)])) == 1


def test_int8_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from yololp_tpu_torch.core.inferer import Inferer
    from yololp_tpu_torch.quant.int8_infer import make_int8_infer_fn
    from yololp_tpu_torch.quant.quantize import calibrate, save_amax
    from yololp_tpu_torch.tools.infer import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inf = Inferer(str(tmp_path), None, "yololpn", img_size=64, half=False, device="cpu")
    batch = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate(inf.model, [batch])
    amax = calibrate(inf.model, [batch], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_int8_infer_fn(inf.model, inf.variables, amax)
    save_amax(amax, str(tmp_path / "amax.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--source", str(tmp_path), "--conf-file", "yololpn", "--not-save-img",
              "--int8", "--calib-pt", str(tmp_path / "amax.json")])
    # the CPU is taken only when asked for, and then runs the plain int8 conv
    det, _, _ = make_int8_infer_fn(inf.model, inf.variables, amax, device="cpu")(batch)
    assert det.device.type == "cpu"


@pytest.mark.parametrize("tool", ["probe_mxu_int8", "probe_pallas_conv", "profile_int8",
                                  "probe_latency", "profile_sections", "bench_nms",
                                  "profile_train", "probe_train_mfu", "probe_int8_e2e"])
def test_measurement_tools_raise_without_a_gpu(tool, monkeypatch):
    import importlib

    main = importlib.import_module(f"yololp_tpu_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = ["--calib-pt", "amax.json"] if tool == "probe_int8_e2e" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--small"] + extra)  # --device defaults to cuda


def test_bench_refuses_without_a_gpu(monkeypatch, capsys):
    """The port's bench prints its error line and exits 3 without a card,
    even with the device probe turned off; each leg takes the card unless
    the CPU is asked for."""
    import json

    from yololp_tpu_torch import bench

    assert "yololp_tpu_torch.bench" in port_modules()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench.os, "nice", lambda inc: 0)
    monkeypatch.setenv("YOLOLP_BENCH_NO_PREFLIGHT", "1")
    monkeypatch.setenv("YOLOLP_BENCH_NO_PAUSE", "1")
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 3
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["value"] is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_train_step(batch=2, img=64, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_inference(torch.nn.Identity(), 2, 64, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_int8(torch.nn.Identity(), {}, 2, 64, iters=1)


def test_the_multi_gpu_modules_and_new_tools_are_checked():
    """parallel/ and the train and int8 probes are among the files and
    modules the two import tests above walk."""
    files = {p.relative_to(ROOT).as_posix() for p in port_files()}
    mods = set(port_modules())
    for name in ("parallel", "parallel/mesh", "parallel/infer", "tools/profile_train",
                 "tools/probe_train_mfu", "tools/probe_int8_e2e"):
        path = f"yololp_tpu_torch/{name}" + ("/__init__.py" if "/" not in name else ".py")
        assert path in files
        assert "yololp_tpu_torch." + name.replace("/", ".") in mods


def test_the_export_modules_are_checked_and_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    """export/, deploy/ (the native runner's build), ops/library.py and
    tools/export.py are among the files and modules the two import tests
    above walk; the export CLI takes the card unless the CPU is asked for."""
    from yololp_tpu_torch.tools.export import main

    files = {p.relative_to(ROOT).as_posix() for p in port_files()}
    mods = set(port_modules())
    for name in ("export/__init__", "export/export", "deploy/__init__", "deploy/aoti_cpp/__init__",
                 "deploy/aoti_cpp/__main__", "ops/library", "tools/export"):
        assert f"yololp_tpu_torch/{name}.py" in files
        assert "yololp_tpu_torch." + name.replace("/", ".").removesuffix(".__init__") in mods
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--conf-file", "yololpn", "--out", str(tmp_path / "m"), "--img-size", "64"])
    assert not list(tmp_path.iterdir())  # refused before any work


def test_parallel_helpers_are_the_identity_outside_a_group(monkeypatch):
    """Without a process group the port is one process: world 1, rank 0,
    sums and broadcasts unchanged, no barrier; initialize_distributed joins
    nothing without torchrun's environment, and never takes NCCL without a
    card."""
    from yololp_tpu_torch.parallel import mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not mesh.initialize_distributed()
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == (1, 0, True)
    t = torch.arange(3.0, requires_grad=True)
    assert mesh.global_sum(t) is t and mesh.global_sum_grad(t) is t
    mesh.barrier()
    assert mesh.data_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        mesh.initialize_distributed("nccl")


def test_matmul_and_dots_route_raise_without_a_gpu(monkeypatch):
    from yololp_tpu_torch.ops import cuda_matmul
    from yololp_tpu_torch.quant.int8_infer import conv3x3_as_dots

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="cuda"):
        cuda_matmul.matmul_cuda(a, a.t().contiguous())
    # the CPU is taken only for CPU tensors, and then runs the plain version
    x = torch.ones(1, 3, 3, 8, dtype=torch.int8)
    acc = conv3x3_as_dots(x, torch.ones(3, 3, 8, 2, dtype=torch.int8))
    assert acc.device.type == "cpu" and int(acc[0, 1, 1, 0]) == 72


def test_eval_and_train_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from yololp_tpu_torch.core.evaler import Evaler, run_eval
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.tools.eval import main
    from yololp_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaler({"val": str(tmp_path)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_eval(None, None, {"val": str(tmp_path)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--synthetic-data", str(tmp_path), "--conf-file", "yololpn"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(Config.named("yololpn"))
    # the CPU is taken only when asked for
    assert Evaler({"val": str(tmp_path)}, device="cpu").device.type == "cpu"


def test_the_loss_stays_on_the_cpu_for_cpu_inputs():
    """The loss builds its anchors on the device of the head outputs: a CPU
    call needs no card."""
    from yololp_tpu_torch.losses.loss import LossConfig, compute_loss
    from yololp_tpu_torch.models.effidehead import HeadTrainOutput

    a = sum((64 // s) ** 2 for s in (8, 16, 32))
    out = HeadTrainOutput(None, torch.full((1, a, 31), 0.5), torch.full((1, a, 24), 0.5),
                          torch.full((1, a, 6, 37), 0.5), torch.ones(1, a, 4), torch.ones(1, a, 8))
    labels = torch.zeros(1, 2, 20)
    labels[..., :8] = -1
    labels[0, 0] = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8, .5, .5, .3, .2] + [.4] * 8)
    total, items = compute_loss(out, labels, torch.tensor([[1.0, 0.0]]),
                                LossConfig(img_size=(64, 64)))
    assert total.device.type == "cpu" and items.shape == (7,) and torch.isfinite(total)


def test_train_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """The trainer, the train CLI, the device cache and the train step's
    model take the card unless the CPU is asked for."""
    import types

    from yololp_tpu_torch.core.engine import Trainer
    from yololp_tpu_torch.data.device_cache import DeviceCachedData
    from yololp_tpu_torch.tools.train import main
    from yololp_tpu_torch.utils.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--synthetic-data", "--conf-file", "yololpn", "--output-dir", str(tmp_path)])
    args = types.SimpleNamespace(img_size=64, batch_size=2, epochs=1, workers=0,
                                 save_dir=str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(args, Config.named("yololpn"), {"train": str(tmp_path)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCachedData(None)
    assert not (tmp_path / "synthetic_data").exists()  # refused before any work


def test_trainer_refuses_what_waits_for_later_items(tmp_path):
    """A device mesh means this process group (one process per card): a
    mesh of two devices in a single process is refused. RepOpt and
    distillation, once
    refused here, now build: the trainer with training_mode 'repopt' and a
    scales file, and with --distill from a teacher checkpoint;
    make_train_step takes masks and a teacher."""
    import types

    from yololp_tpu_torch.core.engine import Trainer
    from yololp_tpu_torch.core.train_step import make_train_step
    from yololp_tpu_torch.losses.loss import LossConfig
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.solver.build import SolverConfig
    from yololp_tpu_torch.solver.repopt import extract_scales, save_scales
    from yololp_tpu_torch.utils.checkpoint import save_checkpoint
    from yololp_tpu_torch.utils.config import Config
    from yololp_tpu_torch.utils.convert import state_dict_to_jax

    args = types.SimpleNamespace(img_size=64, batch_size=2, epochs=1, workers=0, device="cpu",
                                 save_dir=str(tmp_path / "run"))
    with pytest.raises(ValueError, match="one process per card"):
        Trainer(args, Config.named("yololpn"), {"train": str(tmp_path)},
                device_mesh=[torch.device("cpu")] * 2)

    from yololp_tpu_torch.data.synthetic import make_synthetic_dataset

    data = make_synthetic_dataset(str(tmp_path / "data"), n_train=4, n_val=2, img_size=64, seed=0)
    hs = build_model(Config.named("repopt/yolov6n_hs"), seed=1, device="cpu")
    save_scales(extract_scales(hs.state_dict()), str(tmp_path / "scales.msgpack"))
    cfg = Config.named("repopt/yolov6n_opt")
    cfg["scales"] = str(tmp_path / "missing.msgpack")
    with pytest.raises(FileNotFoundError, match="missing.msgpack"):
        Trainer(args, cfg, data)
    cfg["scales"] = str(tmp_path / "scales.msgpack")
    trainer = Trainer(args, cfg, data)
    assert trainer.solver_cfg.weight_decay == pytest.approx(0.0005 * 2 * 32 / 64)

    teacher = build_model(Config.named("yololps"), seed=2, device="cpu")
    save_checkpoint({"format": "train", "variables": state_dict_to_jax(teacher.state_dict())},
                    str(tmp_path / "teacher.msgpack"))
    kd = types.SimpleNamespace(**vars(args), distill=True,
                               teacher_ckpt=str(tmp_path / "teacher.msgpack"),
                               teacher_conf="yololps")
    assert Trainer(kd, Config.named("yololpn"), data).step_fn is not None

    model = torch.nn.Conv2d(3, 3, 1)
    make_train_step(model, LossConfig(), SolverConfig(), 2, grad_masks={"weight": torch.ones(1)})
    make_train_step(model, LossConfig(), SolverConfig(), 2, teacher=torch.nn.Conv2d(3, 3, 1))
    with pytest.raises(KeyError, match="no parameter"):
        make_train_step(model, LossConfig(), SolverConfig(), 2, grad_masks={"nope": None})


def test_the_host_side_modules_are_checked():
    """The encoded-image path, the metrics, transplant and the diagnostic
    and dataset tools are among the files and modules the two import tests
    above walk (none imports jax, cv2, yaml or msgpack at module level)."""
    files = {p.relative_to(ROOT).as_posix() for p in port_files()}
    mods = set(port_modules())
    for name in ("data/native", "utils/metrics", "utils/transplant", "tools/diag_strict",
                 "tools/diag_province", "tools/diag_scan_walls", "tools/transplant",
                 "tools/make_dataset", "tools/generate_plates", "tools/trans_ccpd",
                 "tools/count_ccpd", "tools/voc2yolo", "tools/vis_dataset", "tools/vis_glyphs"):
        assert f"yololp_tpu_torch/{name}.py" in files
        assert "yololp_tpu_torch." + name.replace("/", ".") in mods


@pytest.mark.parametrize("tool", ["diag_strict", "diag_province", "diag_scan_walls",
                                  "transplant"])
def test_diag_and_transplant_tools_raise_without_a_gpu(tool, monkeypatch, tmp_path):
    """The diagnostics and transplant's --data comparison take the card
    unless --device cpu is given; they refuse before reading any file."""
    import importlib

    main = importlib.import_module(f"yololp_tpu_torch.tools.{tool}").main
    missing = str(tmp_path / "missing")
    argv = {"diag_strict": ["--ckpt", missing, "--data", missing],
            "diag_province": ["--ckpt", missing, "--data", missing],
            "diag_scan_walls": ["--small"],
            "transplant": ["--weights", missing, "--conf-file", "yololpn", "--data", missing,
                           "--reference-dir", str(tmp_path)]}[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)  # --device defaults to cuda
    if tool != "diag_scan_walls":  # past the device check: the files are read
        with pytest.raises(FileNotFoundError):
            main(argv + ["--device", "cpu"])
