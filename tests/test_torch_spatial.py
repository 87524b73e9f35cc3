"""The (data, spatial) mesh and height-sharded inference
(yololp_tpu_torch/parallel/mesh.py, parallel/spatial.py) against the JAX
package's `data_spatial_mesh` / `image_sharding` program
(tests/test_parallel.py:35-62), on the 8 virtual CPU devices of
tests/conftest.py.

Tolerances:
  * each halo op on its own, float64: the banded op equals the whole-map op
    within 1e-12 (the same products, summed over other shapes);
  * the port's banded model against its unbanded forward, float64: rtol
    1e-9 (boxes reach ~10^5 px on random weights);
  * yololpn at 128 and 160 px, fp32, against the port's unbanded forward and
    the JAX jitted program on data_spatial_mesh(2, 4): rtol 1e-4, with an
    absolute floor of 1e-3 px on boxes and corners and 1e-4 on scores
    (tests/test_torch_models.py's fp32 tolerance; the two frameworks sum conv
    products in different orders over ~70 convs).
Every parameter and BN statistic is randomized (a zero-initialised head
would score every anchor alike) and the input is random.
"""

import glob
import os.path as osp
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend, 8 devices)
from test_torch_layers import randomize_variables
from test_torch_zoo import narrow
from yololp_tpu.layers.fuse import fuse_variables
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.models.yolo import build_model as jbuild_model
from yololp_tpu.parallel.mesh import data_spatial_mesh as jax_data_spatial_mesh
from yololp_tpu.parallel.mesh import image_sharding as jax_image_sharding
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch import parallel
from yololp_tpu_torch.layers.fuse import fuse_model
from yololp_tpu_torch.models.yolo import Model, build_model, init_parameters
from yololp_tpu_torch.ops import nms as nms_mod
from yololp_tpu_torch.ops.division import unit_pixels
from yololp_tpu_torch.ops.nms import non_max_suppression
from yololp_tpu_torch.parallel import (band_rows, data_sharding, data_spatial_mesh,
                                       image_sharding, replicated)
from yololp_tpu_torch.parallel.spatial import (BandThreads, SpatialError, make_spatial_infer_fn,
                                               run_banded, spatial_forward)
from yololp_tpu_torch.quant.int8_infer import build_int8_model, quantize_kernels_int8
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)

OP_ATOL = 1e-12
F64_RTOL = 1e-9
RTOL, ATOL_PX, ATOL_SCORE = 1e-4, 1e-3, 1e-4


def assert_decode_close(got, want, rtol=RTOL, atol_px=ATOL_PX, atol_score=ATOL_SCORE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=rtol, atol=atol_px)
    np.testing.assert_allclose(got[..., 13:], want[..., 13:], rtol=rtol, atol=atol_score)


def images(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ---------------- the mesh and its shardings ----------------

def test_parallel_exports_the_jax_mesh_names():
    for name in ("data_spatial_mesh", "image_sharding", "data_sharding", "replicated"):
        assert callable(getattr(parallel, name))


def test_data_spatial_mesh_shape_and_entries(monkeypatch):
    mesh = data_spatial_mesh(2, 4, device="cpu")
    assert [len(r) for r in mesh] == [4, 4]
    assert all(d == torch.device("cpu") for r in mesh for d in r)
    with pytest.raises(ValueError):
        data_spatial_mesh(0, 2, device="cpu")
    # row-major over the visible cards (no card is touched to build a grid)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = data_spatial_mesh(2, 2)
    assert cards == [[torch.device("cuda", 0), torch.device("cuda", 1)],
                     [torch.device("cuda", 2), torch.device("cuda", 3)]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="share=True"):
        data_spatial_mesh(2, 2)
    assert data_spatial_mesh(2, 2, share=True) == [[torch.device("cuda", 0),
                                                   torch.device("cuda", 1)]] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert data_spatial_mesh(1, 4, share=True) == [[torch.device("cuda", 0)] * 4]


def test_band_rows_even_uneven_and_too_many():
    assert band_rows(128, 4, 32) == [(0, 32), (32, 64), (64, 96), (96, 128)]
    assert band_rows(160, 4, 32) == [(0, 64), (64, 96), (96, 128), (128, 160)]
    assert band_rows(640, 3, 32) == [(0, 224), (224, 448), (448, 640)]
    with pytest.raises(ValueError, match="at least one row"):
        band_rows(128, 5, 32)
    with pytest.raises(ValueError, match="multiple"):
        band_rows(100, 2, 32)


@pytest.mark.parametrize("size,shape", [(128, (2, 4)), (160, (1, 4)), (96, (3, 3))])
def test_shardings_put_and_gather_round_trip(size, shape):
    mesh = data_spatial_mesh(*shape, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (6, size, 40, 3), np.uint8))
    sh = image_sharding(mesh)
    pieces = sh.put(x)
    rows = band_rows(size, shape[1], 32)
    assert [[tuple(p.shape) for p in row] for row in pieces] == \
        [[(6 // shape[0], b - a, 40, 3) for a, b in rows]] * shape[0]
    assert all(p.is_contiguous() for row in pieces for p in row)
    assert torch.equal(sh.gather(pieces), x)
    for sharding in (data_sharding(mesh), replicated(mesh)):
        assert torch.equal(sharding.gather(sharding.put(x)), x)
    # a 1-d data mesh: one device a row
    flat = [torch.device("cpu")] * shape[0]
    chunks = data_sharding(flat).put(x)
    assert [tuple(c.shape) for c in chunks] == [(6 // shape[0], size, 40, 3)] * shape[0]
    assert torch.equal(data_sharding(flat).gather(chunks), x)
    assert all(torch.equal(p, x) for p in replicated(flat).put(x))


# ---------------- each halo op on its own ----------------

def banded(op, x, blocks, n_rows=1):
    """`op` over the bands of x (NCHW, split on `blocks` of its rows at
    x.shape[2] // blocks[-1][1] rows each), gathered along H."""
    f = x.shape[2] // blocks[-1][1]
    chunks = x.tensor_split(n_rows)
    bands = [[c[:, :, a * f:b * f] for a, b in blocks] for c in chunks]
    threads = BandThreads(n_rows * len(blocks))
    try:
        out, halo = run_banded(lambda i, j, t: op(t), bands, [blocks] * n_rows, threads)
    finally:
        threads.close()
    return torch.cat([torch.cat(row, 2) for row in out]), halo


HALO_OPS = {
    # name: (op(t, w), the kernel's shape, input rows, blocks of the coarsest level)
    "conv3x3_s1": (lambda t, w: F.conv2d(t, w, None, 1, 1), (6, 6, 3, 3), 10,
                   [(0, 2), (2, 3), (3, 4), (4, 5)]),
    "conv3x3_s2": (lambda t, w: F.conv2d(t, w, None, 2, 1), (6, 6, 3, 3), 10,
                   [(0, 2), (2, 3), (3, 4), (4, 5)]),
    "conv1x1_s2": (lambda t, w: F.conv2d(t, w, None, 2, 0), (6, 6, 1, 1), 8,
                   [(0, 1), (1, 2), (2, 3), (3, 4)]),
    # 1-row bands: each takes its 2 halo rows from two bands on either side
    "max_pool5": (lambda t, w: F.max_pool2d(t, 5, 1, 2), None, 5,
                  [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]),
    "max_pool5_uneven": (lambda t, w: F.max_pool2d(t, 5, 1, 2), None, 5,
                         [(0, 2), (2, 3), (3, 4), (4, 5)]),
    "conv_transpose2x2_s2": (lambda t, w: F.conv_transpose2d(t, w, None, 2), (6, 6, 2, 2), 4,
                             [(0, 1), (1, 2), (2, 3), (3, 4)]),
}


@pytest.mark.parametrize("name", sorted(HALO_OPS))
def test_halo_op_equals_the_whole_map_op(name):
    fn, w_shape, rows, blocks = HALO_OPS[name]
    g = torch.Generator().manual_seed(len(name))
    x = torch.randn(4, 6, rows, 7, generator=g, dtype=torch.float64)
    w = torch.randn(w_shape, generator=g, dtype=torch.float64) if w_shape else None
    got, halo = banded(lambda t: fn(t, w), x, blocks, n_rows=2)
    want = fn(x, w)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=OP_ATOL)
    if name.startswith(("conv3", "max")):
        assert halo["rows"] > 0 and halo["bytes"] == halo["rows"] * 2 * 6 * 7 * 8
    else:
        assert halo == {"rows": 0, "bytes": 0}


def test_ops_that_mix_rows_otherwise_are_refused():
    x = torch.randn(1, 2, 4, 4, dtype=torch.float64)
    w3 = torch.ones(2, 2, 3, 3, dtype=x.dtype)
    for op in (lambda t: F.avg_pool2d(t, 3, 1, 1),
               lambda t: torch.cat([t, t], 2),
               lambda t: F.interpolate(t, scale_factor=2),
               lambda t: t.flip(2),
               lambda t: F.conv_transpose2d(t, w3, None, 2),
               lambda t: F.batch_norm(t, None, None, training=True)):
        with pytest.raises(SpatialError):
            banded(op, x, [(0, 2), (2, 4)])
    # a channel cat and a row-local chain run
    got, _ = banded(lambda t: F.relu(torch.cat([t, t * 2], 1)) + 1, x, [(0, 2), (2, 4)])
    torch.testing.assert_close(got, F.relu(torch.cat([x, x * 2], 1)) + 1, rtol=0, atol=0)


def test_a_band_that_raises_stops_every_band():
    x = torch.randn(1, 2, 8, 4, dtype=torch.float64)
    w = torch.randn(2, 2, 3, 3, dtype=torch.float64)

    def op(i, j, t):
        for _ in range(3):
            t = F.conv2d(t, w, None, 1, 1)
        if j == 2:
            raise KeyError("band 2 fails")
        return F.conv2d(t, w, None, 1, 1)

    caught = []

    threads = BandThreads(4)

    def call():
        try:
            run_banded(op, [[x[:, :, 2 * j:2 * j + 2] for j in range(4)]],
                       [[(0, 1), (1, 2), (2, 3), (3, 4)]], threads)
        except KeyError as e:
            caught.append(e)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "a failed band left the others waiting"
    assert len(caught) == 1 and "band 2 fails" in str(caught[0])
    threads.close()


def test_exchange_under_thread_switches_every_microsecond():
    """12 bands of one row (more threads than this test's cores), 1-row
    bands under 24 stacked 3x3 convs and 5x5 pools, the interpreter switching
    threads every microsecond: a halo read from a slot already overwritten
    would change the result."""
    import sys

    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 3, 12, 5, generator=g, dtype=torch.float64)
    w = torch.randn(3, 3, 3, 3, generator=g, dtype=torch.float64) / 3

    def op(t):
        for k in range(24):
            t = F.conv2d(t, w, None, 1, 1) if k % 2 else F.max_pool2d(t, 5, 1, 2)
        return t

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, _ = banded(op, x, [(k, k + 1) for k in range(12)])
    finally:
        sys.setswitchinterval(interval)
    torch.testing.assert_close(got, op(x), rtol=0, atol=OP_ATOL)


def test_band_threads_live_across_calls_until_closed():
    model = fuse_model(random_model(narrow(Config.named("yololpn")), seed=4,
                                    dtype=torch.float32))
    before = threading.active_count()
    fn = spatial_forward(model, data_spatial_mesh(2, 2, device="cpu"))
    assert threading.active_count() == before + 4
    x = torch.from_numpy(images((2, 64, 64, 3)))
    first = fn(x)
    assert torch.equal(fn(x), first) and threading.active_count() == before + 4
    fn.close()
    assert threading.active_count() == before


# ---------------- whole models ----------------

def jax_variables(name, seed, cfg=None):
    _, variables = jbuild_model(cfg or JConfig.named(name), img_size=(64, 64))
    return randomize_variables(jax.tree_util.tree_map(np.asarray, variables), seed)


def jax_spatial(model, variables, x, shape=(2, 4)):
    """The JAX test's program: the forward jitted over
    data_spatial_mesh(*shape), images in image_sharding, a replicated decode."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax_data_spatial_mesh(*shape)
    repl = NamedSharding(mesh, P())
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False),
                  in_shardings=(repl, jax_image_sharding(mesh)), out_shardings=repl)
    return np.asarray(fwd(jax.device_put(variables, repl),
                          jax.device_put(jnp.asarray(x), jax_image_sharding(mesh))))


@pytest.mark.parametrize("size", [128, 160])
def test_yololpn_matches_the_jax_spatial_program(size):
    """2 x 4 mesh at 128 px: P5 bands of one row (the SPPF's 5x5 pools take
    halos from two bands away); at 160 px its 5 rows split 2/1/1/1."""
    variables = jax_variables("yololpn", seed=12)
    x = images((2, size, size, 3), seed=size)
    want = jax_spatial(JModel(JConfig.named("yololpn")), variables, x)
    model = load_state_dict_strict(Model(Config.named("yololpn")),
                                   jax_to_state_dict(variables)).eval()
    with torch.no_grad():
        plain = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    fn = spatial_forward(model, data_spatial_mesh(2, 4, device="cpu"))
    got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == (2, sum((size // s) ** 2 for s in (8, 16, 32)), 290)
    assert_decode_close(got, plain)
    assert_decode_close(got, want)
    assert fn.halo["rows"] > 0


def test_fused_deploy_yololpn_matches_the_jax_spatial_program():
    variables = jax_variables("yololpn", seed=13)
    x = images((2, 128, 128, 3), seed=3)
    fused = jax.tree_util.tree_map(np.asarray, fuse_variables(variables))
    want = jax_spatial(JModel(JConfig.named("yololpn"), deploy=True), fused, x)
    train = load_state_dict_strict(Model(Config.named("yololpn")), jax_to_state_dict(variables))
    deploy = fuse_model(train.eval())
    got = spatial_forward(deploy, data_spatial_mesh(2, 4, device="cpu"))(torch.from_numpy(x))
    with torch.no_grad():
        plain = deploy(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_decode_close(got, plain)
    assert_decode_close(got, want)


def random_model(cfg, seed, dtype=torch.float64):
    """A port model with every parameter and BN statistic drawn from a seeded
    numpy generator (through the JAX tree's randomizer)."""
    from yololp_tpu_torch.utils.convert import state_dict_to_jax

    model = Model(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    variables = randomize_variables(state_dict_to_jax(model.state_dict()), seed)
    return load_state_dict_strict(model, jax_to_state_dict(variables)).eval().to(dtype)


# (config, image size, mesh): BepC3 (CSPBepBackbone, CSPRepBiFPANNeck, SPPF)
# at 160 px, 5 rows over 4 columns; the 4-level head (EfficientRep6 with its
# CSP SPPF at stride 64) at 320 px, 5 rows over 4 columns
ZOO_CASES = {"yolov6m": (160, (1, 4)), "yolov6n6": (320, (2, 4))}


@pytest.mark.parametrize("name", sorted(ZOO_CASES))
@pytest.mark.parametrize("deploy", [False, True])
def test_zoo_spatial_forward_equals_the_unbanded_forward(name, deploy):
    size, shape = ZOO_CASES[name]
    model = random_model(narrow(Config.named(name)), seed=len(name))
    if deploy:
        model = fuse_model(model.float()).double()
    x = torch.from_numpy(images((shape[0], size, size, 3), seed=7).astype(np.float64))
    with torch.no_grad():
        want = model(x.permute(0, 3, 1, 2))
    got = spatial_forward(model, data_spatial_mesh(*shape, device="cpu"))(x)
    assert_decode_close(got, want, rtol=F64_RTOL, atol_px=1e-9, atol_score=1e-12)


def _arch_key(name):
    m = Config.named(name)["model"]
    bb, nk = m["backbone"], m["neck"]
    return (bb["type"], nk["type"], bool(bb.get("cspsppf")), bool(bb.get("fuse_P2")),
            m["head"]["num_layers"], bool(m["head"]["use_dfl"]),
            Config.named(name).get("training_mode", "repvgg"))


_CFG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "yololp_tpu_torch", "configs")
_NAMES = sorted(osp.relpath(p, _CFG_DIR)[:-3].replace(osp.sep, "/")
                for p in glob.glob(osp.join(_CFG_DIR, "**", "*.py"), recursive=True)
                if not osp.basename(p).startswith("_"))
# one config for each set of blocks the zoo's 42 model configs build
OP_FAMILIES = sorted({_arch_key(n): n for n in reversed(_NAMES)
                      if "model" in Config.named(n)}.values())


@pytest.mark.parametrize("name", OP_FAMILIES)
def test_every_block_family_runs_banded_on_meta(name):
    """Each family's train graph (eval mode) and deploy graph run over 2
    bands on the meta device: every op they call is one the halo mode knows."""
    cfg = narrow(Config.named(name))
    for deploy in (False, True):
        with torch.device("meta"):
            model = Model(cfg, deploy=deploy).eval()
        y = spatial_forward(model, data_spatial_mesh(1, 2, device="meta"))(
            torch.empty(1, 128, 128, 3, device="meta"))
        assert tuple(y.shape) == (1, sum((128 // s) ** 2 for s in model.detect.strides), 290)


# ---------------- end to end, and refusals ----------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_infer_fn_detections_equal_plain_nms_on_its_decode(dtype, monkeypatch):
    model = fuse_model(random_model(Config.named("yololpn"), seed=5, dtype=torch.float32))
    u8 = np.random.default_rng(2).integers(0, 256, (4, 128, 128, 3), np.uint8)
    kw = dict(conf_thres=0.3, iou_thres=0.45, max_det=100, pre_nms_topk=256)
    mesh = data_spatial_mesh(2, 2, device="cpu")
    run, put = make_spatial_infer_fn(model, mesh, dtype=dtype, **kw)
    calls = []
    real = nms_mod.greedy_nms_mask
    monkeypatch.setattr(nms_mod, "greedy_nms_mask", lambda *a, **k: calls.append(1) or real(*a, **k))
    det, valid, num = run(put(u8))
    assert len(calls) == 2  # one a data row
    # the same bands through spatial_forward: the decode the NMS ran on
    fwd = spatial_forward(model.to(dtype), mesh)
    pred = fwd(unit_pixels(torch.from_numpy(u8), dtype))
    want = non_max_suppression(pred.float(), **kw)
    for a, b in zip((det, valid, num), want):
        assert torch.equal(a, b)
    assert int(num.min()) > 0
    if dtype == torch.float32:
        with torch.no_grad():
            plain = model(unit_pixels(torch.from_numpy(u8).permute(0, 3, 1, 2), dtype))
        assert_decode_close(pred, plain)
    assert run.halo["rows"] > 0 and run.halo["bytes"] > 0


def test_train_mode_int8_and_too_many_columns_are_refused():
    model = build_model(narrow(Config.named("yololpn")), device="cpu")
    with pytest.raises(SpatialError, match="train mode"):
        spatial_forward(model.train(), data_spatial_mesh(1, 2, device="cpu"))
    deploy = fuse_model(model.eval())
    table = quantize_kernels_int8(deploy.state_dict())
    int8 = build_int8_model(deploy, {p: 4.0 for p in table}, table)
    with pytest.raises(SpatialError, match="int8"):
        make_spatial_infer_fn(int8, data_spatial_mesh(1, 2, device="cpu"))
    fn = spatial_forward(deploy, data_spatial_mesh(1, 5, device="cpu"))
    with pytest.raises(ValueError, match="at least one row"):
        fn(torch.zeros(1, 128, 128, 3))
