"""Port parity: the port's bench (yololp_tpu_torch/bench.py) against the JAX
package's bench.py, leg by leg: each leg's timed program against the
composition bench.py times, built here from the JAX package's own
functions.

Inputs: yololps at 64 px, batch 2, fp32 (the JAX bench runs bf16; parity is
held in fp32), every parameter drawn from seed 16 and carried into the port
by utils/convert.py; uint8 frames from numpy seeds. Seed 16 leaves every
gate score and candidate IoU clear of its threshold by more than the fp32
tolerance (test_seed_keeps_clear_of_thresholds), so counts must be equal.

Tolerances: detections as tests/test_torch_inferer.py holds them (class ids
and counts exactly, boxes, corners and scores within rtol 1e-4 / atol 1e-3);
the chained values' count part exactly and the whole within 2 fp32 ULPs of
their size; the int8 decode within tests/test_torch_int8.py's whole-model
allowance (FLIP_*), its counts exactly; the train step's total
within rtol 1e-3 (ROADMAP C, fact 7: one step from one state) and the
assigner's fg mask exactly.

On the CPU the legs run their kernels' plain versions; the bench's own
entry point refuses the CPU (no card: exit 3 and an error line).
"""

import ast
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_int8 import FLIP_PX, FLIP_SCORE
from test_torch_train_step import fast_jax_variables
from yololp_tpu.core import train_step as jts
from yololp_tpu.layers.fuse import fuse_variables
from yololp_tpu.losses import loss as jloss
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.ops.nms import non_max_suppression as jnms
from yololp_tpu.quant import int8_infer as jint8
from yololp_tpu.solver.build import SolverConfig as JSolverConfig
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch import bench
from yololp_tpu_torch.losses.loss import LossConfig, compute_loss
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.ops.geometry import pairwise_iou, xywh2xyxy
from yololp_tpu_torch.parallel.infer import infer_mesh
from yololp_tpu_torch.quant import int8_infer as tint8
from yololp_tpu_torch.quant.quantize import _image_tensor, calibrate
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH, SEED, K = 64, 2, 16, 3
CPU = torch.device("cpu")
MARGIN = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(flax deploy module, its fused variables, the port's deploy model)."""
    fused = jax.tree_util.tree_map(np.asarray, fuse_variables(fast_jax_variables("yololps", SEED)))
    tmodel = Model(Config.named("yololps"), deploy=True)
    load_state_dict_strict(tmodel, jax_to_state_dict(fused))
    return JModel(JConfig.named("yololps"), deploy=True), fused, tmodel.eval()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(4).integers(0, 255, (BATCH, SIZE, SIZE, 3), np.uint8)


def jax_fwd(jmodel, fused):
    """bench.py's `fwd` (bench.py:263-269) in fp32."""
    def fwd(images_u8):
        x = images_u8.astype(jnp.float32) / jnp.float32(255.0)
        pred = jmodel.apply(fused, x, train=False)
        det, _, num = jnms(pred, conf_thres=0.4, iou_thres=0.45, max_det=300, pre_nms_topk=256)
        return det, num
    return fwd


def jax_scan(fwd, iters):
    """bench.py's `scan_prog` (bench.py:271-277)."""
    def scan_prog(images_u8, c0):
        def body(c, _):
            det, num = fwd(images_u8 + c)
            return c + 1, jnp.sum(det.astype(jnp.float32)) * 1e-9 + jnp.sum(num)
        _, vs = lax.scan(body, c0, None, length=iters)
        return vs
    return scan_prog


def assert_dets_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 20:28], want[..., 20:28])  # class ids
    np.testing.assert_allclose(got[..., :20], want[..., :20], rtol=1e-4, atol=1e-3)


def test_seed_keeps_clear_of_thresholds(pair, images):
    from yololp_tpu_torch.core.inferer import deploy_decode

    pred = deploy_decode(pair[2], images, CPU, torch.float32)
    cls = pred[..., 13:]
    bounds = [0, 31, 55] + [55 + 37 * i for i in range(1, 7)]
    gate = torch.stack([cls[..., a:b].amax(-1) for a, b in zip(bounds, bounds[1:])], -1).mean(-1)
    assert (gate - bench.NMS_KW["conf_thres"]).abs().min() > MARGIN
    passed = gate >= bench.NMS_KW["conf_thres"]
    for i in range(BATCH):
        boxes = xywh2xyxy(pred[i, passed[i], :4])
        assert len(boxes) > 10  # the NMS has work to do
        assert (pairwise_iou(boxes, boxes) - bench.NMS_KW["iou_thres"]).abs().min() > MARGIN


def test_inference_program_and_chained_values_match_jax(pair, images):
    jmodel, fused, tmodel = pair
    jfwd = jax_fwd(jmodel, fused)
    fwd = bench.e2e_fwd(tmodel, CPU)
    det_w, num_w = jax.jit(jfwd)(jnp.asarray(images))
    with torch.inference_mode():
        det, num = fwd(torch.from_numpy(images))
    np.testing.assert_array_equal(num.numpy(), np.asarray(num_w))
    assert int(num.min()) > 0
    assert_dets_match(det, det_w)

    # K chained steps from c0 = 254: the uint8 counter wraps after 255
    want = np.asarray(jax.jit(jax_scan(jfwd, K))(jnp.asarray(images), jnp.uint8(254)))
    got = bench.chained(fwd, K)(torch.from_numpy(images),
                                torch.tensor(254, dtype=torch.uint8)).numpy()
    assert got.shape == want.shape == (K,) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.floor(got), np.floor(want))  # sum(num) of each step
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(want.max())))


def test_sharded_branch_equals_the_single_device_program(pair, images):
    tmodel = pair[2]
    mesh = infer_mesh(2, device="cpu")
    run, put = bench.mesh_fwd(tmodel, mesh)
    got = run(put(images))
    # each replica's chunk against the single-device program on that chunk:
    # a conv's result depends on the batch it runs at (ROADMAP C, fact 9)
    fwd = bench.e2e_fwd(tmodel, CPU)
    with torch.inference_mode():
        chunks = [fwd(torch.from_numpy(images[i:i + 1])) for i in range(BATCH)]
    for a, b in zip(got, zip(*chunks)):
        assert torch.equal(a, torch.cat(b))
    assert int(got[1].min()) > 0
    # both timed branches run to their numbers on the CPU (the plain NMS)
    for m in (mesh, None):
        rates = bench.bench_inference(tmodel, BATCH, SIZE, iters=2, mesh=m, device="cpu")
        assert len(rates) == 2 and all(r > 0 for r in rates)


@pytest.fixture(scope="module")
def int8_case(pair, images):
    """The port's calibration on bench_int8's frames, used by both sides."""
    tmodel = pair[2]
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, 255, (8, SIZE, SIZE, 3), np.uint8) for _ in range(2)]
    return calibrate(tmodel, calib, method="max", device="cpu")


def test_int8_plan_matches_jax_int8_apply(pair, images, int8_case, monkeypatch):
    jmodel, fused, tmodel = pair
    amax = int8_case
    table = jint8.quantize_kernels_int8(fused["params"])

    def jfwd(images_u8):  # bench.py:318-326, fp32
        x = images_u8.astype(jnp.float32) / jnp.float32(255.0)
        pred = jint8.int8_apply(jmodel, fused, x, amax, table, stage_handoffs=True, train=False)
        det, _, num = jnms(pred.astype(jnp.float32), conf_thres=0.4, iou_thres=0.45,
                           max_det=300)
        return det, num, pred

    det_w, num_w, pred_w = (np.asarray(a) for a in jax.jit(jfwd)(jnp.asarray(images)))

    built = []
    real = tint8.build_int8_model
    monkeypatch.setattr(tint8, "build_int8_model",
                        lambda *a, **k: built.append(k) or real(*a, **k))
    run = bench.int8_plan(tmodel, tmodel.state_dict(), amax, device="cpu")
    for _ in range(2):
        det, _, num = run(images)
    # built once, by the conv plan with handoffs
    assert [(k["stage_handoffs"], k["conv_impl"]) for k in built] == [(True, "conv")]
    model = run.int8_model
    assert any(isinstance(m, tint8.Int8Handoff) for m in model.modules())
    assert any(isinstance(m, tint8.Int8RepBlock) for m in model.modules())
    with torch.inference_mode():
        pred = model(_image_tensor(images, CPU, torch.float32)).numpy()
    assert np.abs(pred[..., 13:] - pred_w[..., 13:]).max() <= FLIP_SCORE
    assert np.abs(pred[..., :13] - pred_w[..., :13]).max() <= FLIP_PX
    np.testing.assert_array_equal(num.numpy(), num_w)
    assert int(num.min()) > 0
    assert_dets_match(det, det_w)


def test_bench_int8_raises_instead_of_another_plan(pair, int8_case, monkeypatch):
    tmodel = pair[2]
    assert bench.bench_int8(tmodel, tmodel.state_dict(), BATCH, SIZE, iters=1, device="cpu") > 0

    def broken(*a, **k):
        raise RuntimeError("the plan failed")

    monkeypatch.setattr(tint8, "build_int8_model", broken)
    with pytest.raises(RuntimeError, match="the plan failed"):
        bench.bench_int8(tmodel, tmodel.state_dict(), BATCH, SIZE, iters=1, device="cpu")


def bench_py_labels(batch, img):
    """bench.py's own synthetic batch (bench.py:380-394), its statements run
    as they are written there."""
    tree = ast.parse((ROOT / "bench.py").read_text(encoding="utf-8"))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "bench_train_step")
    start = next(i for i, s in enumerate(fn.body)
                 if isinstance(s, ast.Assign) and ast.unparse(s.targets[0]) == "rng")
    end = next(i for i, s in enumerate(fn.body) if isinstance(s, ast.For))
    ns = {"np": np, "batch": batch, "img": img}
    exec(compile(ast.Module(fn.body[start:end + 1], []), "bench.py", "exec"), ns)
    return ns["images"], ns["labels"], ns["mask"]


def test_train_step_matches_jax_from_one_state():
    from yololp_tpu_torch.tools.profile_train import fake_batch

    want_batch = bench_py_labels(BATCH, SIZE)
    batch = fake_batch(np.random.default_rng(2), BATCH, SIZE)
    for a, b in zip(batch, want_batch):
        np.testing.assert_array_equal(a, b)
    images, labels, mask = batch

    variables = fast_jax_variables("yololps", seed=SEED)
    jmodel = JModel(JConfig.named("yololps"))
    jcfg = jloss.LossConfig(img_size=(SIZE, SIZE), iou_type="giou")
    jstep = jax.jit(jts.make_train_step(jmodel, jcfg, JSolverConfig(epochs=10, steps_per_epoch=100),
                                        batch_size=BATCH))
    _, jtotal, _ = jstep(jts.init_train_state(variables), jnp.asarray(images),
                              jnp.asarray(labels), jnp.asarray(mask))

    model = load_state_dict_strict(Model(Config.named("yololps")), jax_to_state_dict(variables))
    x = images.astype(np.float32) / np.float32(255.0)
    jout, _ = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    jfg = np.asarray(jax.jit(lambda o, lb, m: jloss.compute_loss(o, lb, m, jcfg, with_fg=True)[2])(
        jout, jnp.asarray(labels), jnp.asarray(mask)))
    out = copy.deepcopy(model).train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _, _, fg = compute_loss(out, torch.from_numpy(labels), torch.from_numpy(mask),
                            LossConfig(img_size=(SIZE, SIZE), iou_type="giou"), with_fg=True)
    assert fg.any()
    np.testing.assert_array_equal(fg.numpy(), jfg)

    state, step = bench.train_program(model, BATCH, SIZE, dtype=torch.float32)
    totals = bench.train_scan(step, state, 1)(torch.from_numpy(images), torch.from_numpy(labels),
                                              torch.from_numpy(mask),
                                              torch.zeros((), dtype=torch.uint8))
    assert state.step == 1 and state.ema_updates == 1
    np.testing.assert_allclose(float(totals[0]), float(jtotal), rtol=1e-3)


def test_train_leg_runs_chained_steps_on_the_cpu():
    assert bench.bench_train_step(batch=BATCH, img=SIZE, iters=1, device="cpu") > 0


def line_keys(path):
    """Every key the module can put into its JSON line: the string keys of
    its dict literals and of its subscript stores (an f-string key as its
    template)."""
    def key(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            return "".join(v.value if isinstance(v, ast.Constant) else "{%s}" % ast.unparse(v.value)
                           for v in node.values)
        return None

    keys = set()
    for node in ast.walk(ast.parse(Path(path).read_text(encoding="utf-8"))):
        if isinstance(node, ast.Dict):
            keys.update(key(k) for k in node.keys if k is not None)
        elif isinstance(node, ast.Assign):
            keys.update(key(t.slice) for t in node.targets if isinstance(t, ast.Subscript))
    keys.discard(None)
    return keys


def test_the_line_has_bench_py_keys_but_vs_baseline():
    want = line_keys(ROOT / "bench.py")
    assert {"value", "int8_images_per_sec", "train_ms_per_step_b128", "{key}_sync_images_per_sec",
            "preproc_images_per_sec", "e2e_decode_incl_images_per_sec"} <= want
    assert line_keys(bench.__file__) == want - {"vs_baseline"}
    assert [k for k in bench.native_packages()] == ["native_int8", "native_bf16"]


def test_no_measurement_without_a_card():
    env = dict(os.environ, YOLOLP_BENCH_NO_PAUSE="1")
    out = subprocess.run([sys.executable, "-m", "yololp_tpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] is None and "error" in line and "vs_baseline" not in line
    assert line["preflight"].startswith("probe exited rc=")


def test_preproc_times_the_native_decoder_only(monkeypatch):
    from yololp_tpu_torch.data import native

    rate = bench.bench_preproc(n=8, size=SIZE, src=(72, 116))
    if native.opencv_present():
        assert rate > 0
    else:
        assert rate is None
    # where OpenCV's headers are absent, the cv2 fallback is never timed
    monkeypatch.setattr(native, "opencv_present", lambda: False)
    assert bench.bench_preproc(n=8, size=SIZE, src=(72, 116)) is None


def test_native_runner_leg_reports_an_absent_package(tmp_path, monkeypatch):
    from yololp_tpu_torch.deploy import aoti_cpp

    monkeypatch.setattr(aoti_cpp, "build_runner", lambda: pytest.fail("built the runner"))
    with pytest.raises(FileNotFoundError, match="no AOTInductor package"):
        bench.bench_native_runner(tmp_path / "absent.aoti.pt2")
    pkgs = bench.native_packages()
    assert all(p.parent == ROOT / "build" / "bench" for p in pkgs.values())
    assert pkgs["native_bf16"].name == "yololps_bf16_640_b128.aoti.pt2"


def test_packages_are_exported_once_into_the_bench_dir(tmp_path, monkeypatch):
    from yololp_tpu_torch.export import export as ex

    calls = []

    def fake_export(cfg, weights, stem, **kw):
        calls.append((Path(stem).name, kw))
        Path(stem + ".aoti.pt2").write_bytes(b"")

    monkeypatch.setattr(ex, "export_pt2", fake_export)
    monkeypatch.setattr(bench, "BENCH_DIR", tmp_path)
    bench._ensure_native_artifacts(batch=1, img=SIZE, device="cpu")
    calib = tmp_path / f"yololps_bench_calib_{SIZE}.json"
    assert [(name, kw["calib_pt"], kw["batch"], kw["aoti"]) for name, kw in calls] == [
        (f"yololps_bf16_{SIZE}_b1", None, 1, True),
        (f"yololps_int8_{SIZE}_b1", str(calib), 1, True)]
    assert calib.is_file() and all(p.is_file() for p in bench.native_packages(1, SIZE).values())
    calls.clear()
    bench._ensure_native_artifacts(batch=1, img=SIZE, device="cpu")
    assert not calls  # reused on every later call
