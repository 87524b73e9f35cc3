"""Port parity: NMS over the 290-column decode and the greedy keep-mask.

All inputs are made with numpy from a seed and fed to both packages. The
port repeats the JAX operation order (xyxy codec, IoU, the left-to-right sum
of the 8 task confidences, a stable descending sort in place of lax.top_k),
so keep masks, order, counts and detections must be EQUAL, not close.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py); on
the CPU `greedy_nms_mask` runs its plain version, which is what these tests pin,
together with the plain mirrors of the kernel's two steps (the packed
suppression words and the walk over kept rows).
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
    k300 = np.stack([clustered_boxes(300) for _ in range(2)])
    return {
        "clustered": (clustered, sorted_scores(b, k), 0.45),
        "clustered_high_iou": (clustered, sorted_scores(b, k), 0.65),
        "zero_tail": (clustered, sorted_scores(b, k, zero_tail=90), 0.45),
        "ties": (clustered, tied, 0.45),
        "deep_chain": (chain_boxes(128)[None], np.linspace(1.0, 0.5, 128, dtype=np.float32)[None], 0.2),
        "degenerate": (degenerate(clustered), sorted_scores(b, k), 0.45),
        # K not a multiple of 32 or 64: a ragged last word
        "K300": (k300, sorted_scores(2, 300, zero_tail=100), 0.45),
        "K1000": (clustered_boxes(1000)[None], sorted_scores(1, 1000), 0.45),
        "K1": (clustered_boxes(2)[:, None], np.array([[0.7], [0.0]], np.float32), 0.45),
        "all_scores_zero": (clustered, np.zeros((b, k), np.float32), 0.45),
        # a chain through all 512 rows: it crosses every 64-row band and every
        # block of the kernel's cluster
        "band_chain": (chain_boxes(512)[None], np.linspace(1.0, 0.5, 512, dtype=np.float32)[None], 0.2),
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
    chain_kept = {"deep_chain": 64, "band_chain": 256}
    if case in chain_kept:
        assert got.sum() == chain_kept[case]


@pytest.mark.parametrize("case", sorted(mask_cases()))
def test_words_and_walk_equal_plain_and_jax_mask(case):
    """The kernel's design in plain PyTorch: packed upper-triangular words,
    then the walk over kept rows, equal to the fixpoint and to JAX."""
    boxes, scores, thr = mask_cases()[case]
    b, k = scores.shape
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    words = cuda_nms.suppression_words_plain(tb, thr)
    assert words.shape == (b, k, -(-k // 32)) and words.dtype == torch.int64
    assert int(words.min()) >= 0 and int(words.max()) < 2 ** 32
    got = cuda_nms.walk_kept_rows_plain(words, ts > 0)
    assert got.dtype == torch.bool and got.shape == (b, k)
    np.testing.assert_array_equal(got.numpy(), cuda_nms.greedy_nms_mask_plain(tb, ts, thr).numpy())
    want = np.asarray(jnms.greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_suppression_words_pack_the_upper_triangle():
    boxes = torch.from_numpy(chain_boxes(40)[None])  # box i overlaps box i + 1 only
    words = cuda_nms.suppression_words_plain(boxes, 0.2)[0]
    assert words.shape == (40, 2)
    for i in range(40):
        j = i + 1
        want = [0, 0]
        if j < 40:
            want[j >> 5] = 1 << (j & 31)
        assert words[i].tolist() == want, i
    # nothing at or left of the diagonal, even where the IoU is 1
    same = torch.zeros(1, 3, 4) + torch.tensor([0.0, 0.0, 10.0, 10.0])
    assert cuda_nms.suppression_words_plain(same, 0.5)[0, :, 0].tolist() == [0b110, 0b100, 0]


@pytest.mark.parametrize("case", ["clustered", "zero_tail", "deep_chain", "K300"])
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
    """The JAX function's "approx" selector and nms_iters bound, once refused,
    run now (tests/test_torch_nms_variants.py holds them against JAX); a
    selector of neither name raises."""
    pred = torch.from_numpy(make_decode(b=1, a=200))
    topk = tnms.non_max_suppression(pred, pre_nms_topk=64)
    approx = tnms.non_max_suppression(pred, pre_nms_topk=64, candidate_selector="approx")
    assert all(torch.equal(a, t) for a, t in zip(approx, topk))
    det, valid, num = tnms.non_max_suppression(pred, nms_iters=16)
    assert det.shape == (1, 200, 28) and int(num[0]) == int(valid.sum()) > 0
    with pytest.raises(ValueError, match="approx"):
        tnms.non_max_suppression(pred, candidate_selector="approx_max_k")


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
