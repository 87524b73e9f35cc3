"""Port parity: NMS over the 290-column decode and the greedy keep-mask.

All inputs are made with numpy from a seed and fed to both packages. The
port repeats the JAX operation order (xyxy codec, IoU, the left-to-right sum
of the 8 task confidences, a stable descending sort in place of lax.top_k),
so keep masks, order, counts and detections must be EQUAL, not close.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py); on
the CPU `greedy_nms_mask` runs its plain version, which is what these tests pin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_nms import clustered_boxes, numpy_greedy_nms
from yololp_tpu.ops import nms as jnms
from yololp_tpu.ops.pallas_nms import pallas_greedy_nms_mask
from yololp_tpu_torch.ops import cuda_nms
from yololp_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)

rng = np.random.default_rng(23)



def sorted_scores(b, k, zero_tail=0):
    s = np.sort(rng.uniform(0.01, 1.0, (b, k)).astype(np.float32), -1)[:, ::-1].copy()
    if zero_tail:
        s[:, k - zero_tail:] = 0.0
    return s


def chain_boxes(n):
    """Box i overlaps only box i+1 (IoU 1/4): greedy keeps every other box."""
    xs = np.arange(n, dtype=np.float32) * 6.0
    return np.stack([xs, np.zeros(n, np.float32), xs + 10.0,
                     np.full(n, 10.0, np.float32)], -1)


def degenerate(boxes):
    """Swap the corners of every third box so that x2 < x1 and y2 < y1."""
    out = boxes.copy()
    out[..., ::3, :] = out[..., ::3, :][..., [2, 3, 0, 1]]
    return out


def mask_cases():
    """name -> (boxes (B, K, 4), sorted scores (B, K), iou_thres)."""
    b, k = 3, 256
    clustered = np.stack([clustered_boxes(k) for _ in range(b)])
    tied = sorted_scores(b, k)
    tied[:, 40:120] = tied[:, 40:41]  # a run of exact ties, still sorted
    return {
        "clustered": (clustered, sorted_scores(b, k), 0.45),
        "clustered_high_iou": (clustered, sorted_scores(b, k), 0.65),
        "zero_tail": (clustered, sorted_scores(b, k, zero_tail=90), 0.45),
        "ties": (clustered, tied, 0.45),
        "deep_chain": (chain_boxes(128)[None], np.linspace(1.0, 0.5, 128, dtype=np.float32)[None], 0.2),
        "degenerate": (degenerate(clustered), sorted_scores(b, k), 0.45),
    }


@pytest.mark.parametrize("case", sorted(mask_cases()))
def test_plain_mask_equals_jax_greedy_mask(case):
    boxes, scores, thr = mask_cases()[case]
    want = np.asarray(jnms.greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr))
    got = cuda_nms.greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if case != "degenerate":  # the oracle and the Pallas kernel do not clip areas
        for i in range(len(boxes)):
            ref = numpy_greedy_nms(boxes[i], scores[i], thr) & (scores[i] > 0)
            np.testing.assert_array_equal(got[i].numpy(), ref)
    if case == "deep_chain":
        assert got.sum() == 64


@pytest.mark.parametrize("case", ["clustered", "zero_tail", "deep_chain"])
def test_plain_mask_equals_pallas_kernel_in_interpret_mode(case):
    boxes, scores, thr = mask_cases()[case]
    want = np.asarray(pallas_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr,
                                             interpret=True))
    got = cuda_nms.greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr)
    np.testing.assert_array_equal(got.numpy(), want)


def make_decode(b=2, a=700, seed=0):
    """A (B, A, 290) decode: clustered boxes (some degenerate), random task
    scores, and duplicated rows so that exact score ties reach the top-k."""
    r = np.random.default_rng(seed)
    pred = np.zeros((b, a, 290), np.float32)
    for i in range(b):
        xyxy = degenerate(clustered_boxes(a)) if i else clustered_boxes(a)
        pred[i, :, 0:2] = (xyxy[:, :2] + xyxy[:, 2:]) / 2
        pred[i, :, 2:4] = xyxy[:, 2:] - xyxy[:, :2]
    pred[..., 4] = 1.0
    pred[..., 5:13] = r.uniform(0, 640, (b, a, 8))
    pred[..., 13:] = r.uniform(0, 1, (b, a, 277)) ** 4
    pred[:, 100:160] = pred[:, 40:100]  # exact duplicates: tied scores, IoU 1
    return pred


@pytest.mark.parametrize("kw", [
    dict(conf_thres=0.25, iou_thres=0.45, max_det=300),
    dict(conf_thres=0.3, iou_thres=0.65, max_det=1000),
    dict(conf_thres=0.25, iou_thres=0.45, max_det=50, pre_nms_topk=128),
    dict(conf_thres=0.28, iou_thres=0.45, max_det=300, compat_ad4_bug=True),
    dict(conf_thres=0.9, iou_thres=0.45, max_det=300),  # nothing passes the gate
])
def test_non_max_suppression_equals_jax(kw):
    pred = make_decode()
    jdet, jvalid, jnum = (np.asarray(t) for t in jnms.non_max_suppression(jnp.asarray(pred), **kw))
    det, valid, num = tnms.non_max_suppression(torch.from_numpy(pred), **kw)
    k = min(kw.get("pre_nms_topk", 512), pred.shape[1])
    assert det.shape == (2, min(kw["max_det"], k), 28) and det.dtype == torch.float32
    assert num.dtype == torch.int32
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(num.numpy(), jnum)
    np.testing.assert_array_equal(det.numpy(), jdet)
    if kw["conf_thres"] < 0.5:
        assert 0 < jnum.min() and jnum.max() < k  # the gate and suppression both bite


def test_stable_compact_order_equals_jax():
    r = np.random.default_rng(1)
    for kk, md in ((17, 5), (64, 64), (512, 300)):
        keep = r.random((4, kk)) < 0.3
        keep[0] = True
        keep[1] = False
        want = np.asarray(jnms.stable_compact_order(jnp.asarray(keep), md))
        got = tnms.stable_compact_order(torch.from_numpy(keep), md)
        np.testing.assert_array_equal(got.numpy(), want)


def test_unported_options_raise():
    pred = torch.from_numpy(make_decode(b=1, a=200))
    with pytest.raises(NotImplementedError, match="approx"):
        tnms.non_max_suppression(pred, candidate_selector="approx")
    with pytest.raises(NotImplementedError):
        tnms.non_max_suppression(pred, nms_iters=16)


def test_kernel_wrapper_checks_inputs():
    boxes = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms_mask_cuda(boxes[..., :3], torch.ones(2, 8), 0.45)
    with pytest.raises(TypeError):
        cuda_nms.greedy_nms_mask_cuda(boxes.double(), torch.ones(2, 8), 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nms.greedy_nms_mask_cuda(boxes.transpose(0, 1), torch.ones(8, 2), 0.45)
    with pytest.raises(ValueError, match="limit"):
        cuda_nms.greedy_nms_mask_cuda(torch.zeros(1, 1025, 4), torch.ones(1, 1025), 0.45)
    with pytest.raises(ValueError, match="cuda"):
        cuda_nms.greedy_nms_mask_cuda(boxes, torch.ones(2, 8), 0.45)

