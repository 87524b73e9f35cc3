"""Port parity: the JAX NMS's two variants, the "approx" candidate selector
and the fixed fixpoint bound `nms_iters` (ops/nms.py, ops/cuda_nms.py).

Off the TPU, XLA lowers lax.approx_max_k to an exact sort, so jitted JAX on
the CPU selects with "approx" what lax.top_k selects, ties included; the
port's "approx" takes the same stable top-K. `nms_iters=N > 0` runs N steps
of the parallel update map from keep = valid (JAX's fori_loop) in place of
the exact mask. Inputs are made with numpy from a seed, and the JAX side is
the jitted function: keep-masks, detection order, detections and counts
must be EQUAL. The boxes' IoUs lie off the thresholds (the chains' IoU is
exactly 1/4 against a threshold of 0.2), so no tie at the threshold decides
a mask.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_nms import chain_boxes, make_decode, mask_cases
from yololp_tpu.ops import nms as jnms
from yololp_tpu_torch.ops import cuda_nms
from yololp_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)

ITERS = (1, 2, 16)
jax_mask = jax.jit(jnms.greedy_nms_mask, static_argnames=("iou_thres", "iters"))


def tied_decode(b=2, a=1200, seed=5):
    """A decode whose scores come in a few exact values: blocks of 100
    anchors share one score, so the top K cuts through runs of ties."""
    r = np.random.default_rng(seed)
    pred = make_decode(b, a, seed)
    pred[..., 13:] = 0.0
    levels = r.choice([0.3, 0.5, 0.7], size=(b, a // 100)).repeat(100, axis=1)
    for s in [13, 44] + [68 + i * 37 for i in range(6)]:
        pred[..., s] = levels
    return pred


def chain_decode(a=600):
    """A decode whose anchors form one suppression chain (box i overlaps
    only box i + 1, IoU 1/4) with strictly falling scores: greedy keeps
    every other box, and a bound of N steps resolves only the chain's head."""
    xyxy = chain_boxes(a)
    pred = np.zeros((1, a, 290), np.float32)
    pred[0, :, 0:2] = (xyxy[:, :2] + xyxy[:, 2:]) / 2
    pred[0, :, 2:4] = xyxy[:, 2:] - xyxy[:, :2]
    pred[..., 4] = 1.0
    for s in [13, 44] + [68 + i * 37 for i in range(6)]:
        pred[0, :, s] = np.linspace(0.9, 0.5, a, dtype=np.float32)
    return np.repeat(pred, 2, axis=0)


DECODES = {
    "clustered_a700": functools.partial(make_decode, 2, 700, 0),
    "ties_a1200": tied_decode,
    "a300": functools.partial(make_decode, 2, 300, 3),  # K = 512 >= A: the topk branch
    "chain_a600": chain_decode,
}
CALLS = [  # (decode, keyword arguments)
    ("clustered_a700", dict(conf_thres=0.25, iou_thres=0.45, max_det=300)),
    ("clustered_a700", dict(conf_thres=0.25, iou_thres=0.65, max_det=100, pre_nms_topk=64)),
    ("ties_a1200", dict(conf_thres=0.25, iou_thres=0.45, max_det=300, pre_nms_topk=256)),
    ("a300", dict(conf_thres=0.25, iou_thres=0.45, max_det=300)),
    ("chain_a600", dict(conf_thres=0.25, iou_thres=0.2, max_det=512)),
]


@functools.lru_cache(maxsize=None)
def decode(name):
    return DECODES[name]()


def run_both(name, **kw):
    pred = decode(name)
    want = [np.asarray(t) for t in jnms.non_max_suppression(jnp.asarray(pred), **kw)]
    got = [t.numpy() for t in tnms.non_max_suppression(torch.from_numpy(pred), **kw)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("name,kw", CALLS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CALLS)])
def test_approx_selector_equals_jax_and_topk(name, kw):
    approx = run_both(name, candidate_selector="approx", **kw)
    topk = tnms.non_max_suppression(torch.from_numpy(decode(name)), **kw)
    for a, t in zip(approx, topk):
        np.testing.assert_array_equal(a, t.numpy())
    assert approx[2].min() > 0


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("name,kw", CALLS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CALLS)])
def test_nms_iters_equals_jax(name, kw, iters):
    det, valid, num = run_both(name, nms_iters=iters, candidate_selector="approx", **kw)
    exact = tnms.non_max_suppression(torch.from_numpy(decode(name)), **kw)
    if name == "chain_a600":
        # the chain is deeper than any bound here: the bound bites
        assert not np.array_equal(valid, exact[1].numpy())
        assert num.tolist() != exact[2].tolist()


MASK_CASES = ("clustered", "ties", "zero_tail", "degenerate", "K300", "deep_chain", "band_chain")


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("case", MASK_CASES)
def test_bounded_mask_equals_jax(case, iters):
    boxes, scores, thr = mask_cases()[case]
    want = np.asarray(jax_mask(jnp.asarray(boxes), jnp.asarray(scores), iou_thres=thr,
                               iters=iters))
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = cuda_nms.greedy_nms_mask(tb, ts, thr, iters=iters)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tnms.greedy_nms_mask(tb, ts, thr, iters=iters).numpy(), want)  # the re-export
    if case.endswith("chain"):
        exact = cuda_nms.greedy_nms_mask(tb, ts, thr)
        assert not torch.equal(got, exact)
        # N steps settle the first N boxes of the chain
        assert torch.equal(got[:, :iters], exact[:, :iters])


@pytest.fixture(scope="module")
def deploy_yololpn():
    from yololp_tpu_torch.layers.fuse import fuse_model
    from yololp_tpu_torch.models.yolo import build_model
    from yololp_tpu_torch.utils.config import Config

    return fuse_model(build_model(Config.named("yololpn"), seed=3, device="cpu").eval())


@pytest.mark.parametrize("path", ["spatial", "int8"])
def test_selector_reaches_the_nms_of_each_infer_fn(path, deploy_yololpn, monkeypatch):
    """The spatial and int8 infer functions hand their selector to the NMS
    (the bf16, eval and sharded paths: tests/test_torch_{inferer,evaler}.py),
    and "approx" gives what "topk" gives."""
    import importlib

    module = importlib.import_module({"spatial": "yololp_tpu_torch.parallel.spatial",
                                      "int8": "yololp_tpu_torch.quant.int8_infer"}[path])
    seen = []
    real = module.non_max_suppression
    monkeypatch.setattr(module, "non_max_suppression",
                        lambda *a, **k: seen.append(k["candidate_selector"]) or real(*a, **k))
    u8 = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), np.uint8)
    kw = dict(conf_thres=0.0, iou_thres=0.45, max_det=50)
    outs = []
    for sel in tnms.SELECTORS:
        if path == "spatial":
            from yololp_tpu_torch.parallel import data_spatial_mesh

            run, put = module.make_spatial_infer_fn(deploy_yololpn, data_spatial_mesh(
                1, 2, device="cpu"), candidate_selector=sel, **kw)
            outs.append(run(put(u8)))
            run.close()
        else:
            table = module.quantize_kernels_int8(deploy_yololpn.state_dict())
            run = module.make_int8_infer_fn(deploy_yololpn, deploy_yololpn.state_dict(),
                                            {p: 4.0 for p in table}, candidate_selector=sel,
                                            device="cpu", **kw)
            outs.append(run(u8))
    assert seen == list(tnms.SELECTORS)
    for a, t in zip(*outs):
        assert torch.equal(a, t)
    assert int(outs[0][2].min()) > 0
