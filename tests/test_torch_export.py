"""Port parity: export (yololp_tpu_torch/export/export.py, tools/export.py)
against the live port and the JAX StableHLO artifact, on the CPU.

yololpn at 128 px in fp32 from tests/test_torch_inferer.py's seeded
checkpoint (seed 41, conf 0.5, iou 0.45, max_det 20; its thresholds sit clear
of the tolerance there) on the same two letterboxed images. The end2end
`.pt2`, saved and loaded, replays the live port's ops: det/valid/num equal
`Inferer._run`'s bit for bit, and its graph holds exactly one
`yololp_torch.nms_gate` and one `yololp_torch.greedy_nms_mask` node. Against the JAX `export_stablehlo`
artifact, deserialized and run as tests/test_export.py runs it: num and
valid equal, detections within tests/test_torch_inferer.py's tolerance
(class ids exact, the rest rtol 1e-4 / atol 1e-3: fp32 conv-order
differences); the raw flavour's decode within the same tolerance. Then the
CLI on the CPU.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_models import jax_variables
from yololp_tpu.utils import checkpoint as jckpt
from yololp_tpu_torch.core.inferer import Inferer
from yololp_tpu_torch.export.export import export_pt2

torch.set_num_threads(2)

KW = dict(conf_thres=0.5, iou_thres=0.45, max_det=20)
IMG = 128
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    ckpt = str(d / "yololpn.msgpack")
    jckpt.save_checkpoint({"format": "train", "step": 0,
                           "variables": jax_variables("yololpn", seed=41),
                           "ema": None, "opt_state": None, "meta": {}}, ckpt)
    inf = Inferer(str(d), ckpt, "yololpn", img_size=IMG, half=False, device="cpu", **KW)
    rng = np.random.default_rng(4)  # tests/test_torch_inferer.py's images
    images = [rng.integers(0, 255, (200, 260, 3), np.uint8),
              rng.integers(0, 255, (128, 96, 3), np.uint8)]
    batch = np.stack([inf.precess_image(im) for im in images])
    return d, ckpt, inf, batch


def deserialize_and_run(path, batch):
    """tests/test_export.py's helper: compile the portable artifact through
    the PJRT client, as the JAX C++ runner does, and run it."""
    from jax._src.interpreters import mlir as jmlir
    from jaxlib import _jax
    from jaxlib.mlir.dialects import stablehlo

    with open(path, "rb") as f:
        blob = f.read()
    with jmlir.make_ir_context() as ctx:
        module = stablehlo.deserialize_portable_artifact(ctx, blob)
        client = jax.devices()[0].client
        dl = _jax.DeviceList(tuple(jax.devices()[:1]))
        compiled = client.compile_and_load(module, dl, _jax.CompileOptions())
    out = compiled.execute_sharded([jax.device_put(jnp.asarray(batch))])
    return [np.asarray(a[0]) for a in out.disassemble_into_single_device_arrays()]


def jax_artifact(d, ckpt, batch, end2end, name, calib_pt=None):
    from yololp_tpu.export.export import export_stablehlo

    path, _ = export_stablehlo("yololpn", ckpt, str(d / name), batch=len(batch), img_size=IMG,
                               end2end=end2end, half=False, calib_pt=calib_pt, **KW)
    return deserialize_and_run(path, batch)


def run_pt2(path, batch):
    with torch.no_grad():
        return torch.export.load(path).module()(torch.from_numpy(batch))


# the deploy graph's epilogue op, one a biased conv (71 in yololpn)
EPILOGUES = ["yololp_torch.bias_act.default"] * 71


def custom_op_nodes(path):
    graph = torch.export.load(path).graph
    return [str(n.target) for n in graph.nodes
            if n.op == "call_function" and "yololp_torch" in str(n.target)]


def assert_dets_close(got, want):
    np.testing.assert_array_equal(got[..., 20:28], want[..., 20:28])  # class ids
    np.testing.assert_allclose(got[..., :20], want[..., :20], rtol=RTOL, atol=ATOL)


def test_end2end_pt2_equals_the_live_port_and_the_jax_artifact(setup):
    d, ckpt, inf, batch = setup
    paths = export_pt2("yololpn", ckpt, str(d / "m_fp32"), batch=2, img_size=IMG, half=False,
                       device="cpu", **KW)
    assert custom_op_nodes(paths["pt2"]) == EPILOGUES + ["yololp_torch.nms_gate.default",
                                                         "yololp_torch.greedy_nms_mask.default"]
    got = run_pt2(paths["pt2"], batch)
    want = inf._run(batch)
    for name, a, b in zip(("det", "valid", "num"), got, want):
        assert torch.equal(a, b), name
    assert int(got[2].min()) > 0

    jdet, jvalid, jnum = jax_artifact(d, ckpt, batch, True, "m_fp32.stablehlo")
    np.testing.assert_array_equal(got[2].numpy(), jnum)
    np.testing.assert_array_equal(got[1].numpy(), jvalid)
    assert_dets_close(got[0].numpy(), jdet)


def test_raw_pt2_decode_matches_the_jax_artifact(setup):
    d, ckpt, inf, batch = setup
    paths = export_pt2("yololpn", ckpt, str(d / "raw.pt2"), batch=2, img_size=IMG, half=False,
                       end2end=False, device="cpu", **KW)
    assert paths["pt2"] == str(d / "raw.pt2") and custom_op_nodes(paths["pt2"]) == EPILOGUES
    got = run_pt2(paths["pt2"], batch).numpy()
    assert np.array_equal(got, inf.predict(batch).numpy())
    (want,) = jax_artifact(d, ckpt, batch, False, "raw.stablehlo")
    assert got.shape == want.shape == (2, sum((IMG // s) ** 2 for s in (8, 16, 32)), 290)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    meta = json.load(open(paths["json"]))
    assert meta["outputs"] == [{"name": "pred", "shape": list(got.shape), "dtype": "float32"}]


def test_cli_exports_on_the_cpu_and_refuses_what_it_cannot(setup, monkeypatch):
    from yololp_tpu_torch.tools.export import main

    d, ckpt, _, _ = setup
    out = str(d / "cli")
    paths = main(["--weights", ckpt, "--conf-file", "yololpn", "--out", out, "--img-size", "64",
                  "--max-det", "10", "--fp32", "--device", "cpu"])
    assert paths == {"pt2": out + ".pt2", "json": out + ".json"}
    meta = json.load(open(paths["json"]))
    assert set(meta) == {"input", "outputs", "end2end", "int8", "conf_thres", "iou_thres",
                         "max_det", "torch_version", "device"}
    assert meta["input"] == {"shape": [1, 64, 64, 3], "dtype": "uint8"}
    assert meta["outputs"] == [
        {"name": "detections", "shape": [1, 10, 28], "dtype": "float32"},
        {"name": "valid", "shape": [1, 10], "dtype": "bool"},
        {"name": "num", "shape": [1], "dtype": "int32"}]
    assert (meta["end2end"], meta["int8"], meta["device"]) == (True, False, "cpu")
    det, valid, num = run_pt2(paths["pt2"], np.zeros((1, 64, 64, 3), np.uint8))
    assert det.shape == (1, 10, 28) and num.dtype == torch.int32

    with pytest.raises(NotImplementedError, match="tensorflow"):
        main(["--conf-file", "yololpn", "--out", out, "--format", "saved_model",
              "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--conf-file", "yololpn", "--out", out, "--int8", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--conf-file", "yololpn", "--out", str(d / "nocard"), "--img-size", "64"])
    assert not (d / "nocard.pt2").exists()
