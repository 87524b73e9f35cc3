"""Port parity: box codecs, anchors and pairwise IoU against the JAX functions.

Inputs are made with numpy from a seed and fed to both packages. The port
follows the JAX operation order, so results must agree to the bit
(assert_array_equal): any difference would be an operation-order slip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.ops import anchors as janchors
from yololp_tpu.ops import geometry as jgeo
from yololp_tpu_torch.ops import anchors as tanchors
from yololp_tpu_torch.ops import geometry as tgeo

rng = np.random.default_rng(11)


def _both(fn_j, fn_t, *arrays, **kw):
    j = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays], **kw))
    t = fn_t(*[torch.from_numpy(a) for a in arrays], **kw).numpy()
    return j, t


def test_xywh2xyxy_matches_jax():
    b = rng.uniform(-50, 700, (3, 17, 4)).astype(np.float32)
    j, t = _both(jgeo.xywh2xyxy, tgeo.xywh2xyxy, b)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("box_format", ["xyxy", "xywh"])
def test_dist2bbox_matches_jax(box_format):
    dist = rng.uniform(-5, 20, (2, 30, 4)).astype(np.float32)
    pts = rng.uniform(0, 80, (30, 2)).astype(np.float32)
    j, t = _both(jgeo.dist2bbox, tgeo.dist2bbox, dist, pts, box_format=box_format)
    np.testing.assert_array_equal(t, j)


def test_dist2cor_matches_jax():
    dist = rng.uniform(-5, 20, (2, 30, 8)).astype(np.float32)
    pts = rng.uniform(0, 80, (30, 2)).astype(np.float32)
    j, t = _both(jgeo.dist2cor, tgeo.dist2cor, dist, pts)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("img", [(64, 64), (96, 160), (640, 640)])
def test_anchor_points_match_jax(img):
    strides = (8, 16, 32)
    shapes = [(img[0] // s, img[1] // s) for s in strides]
    jp, js = janchors.anchor_points_from_shapes(shapes, strides, 0.5)
    tp, ts = tanchors.anchor_points_from_shapes(shapes, strides, 0.5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_pairwise_iou_matches_jax_with_degenerate_boxes():
    """Includes boxes with x2 < x1 or y2 < y1: the areas are clipped at 0 on
    both sides, so their IoU is 0 rather than a negative-area artefact."""
    b1 = rng.uniform(0, 100, (2, 40, 4)).astype(np.float32)
    b2 = rng.uniform(0, 100, (2, 50, 4)).astype(np.float32)
    b1[:, ::2, 2:] = b1[:, ::2, :2] + rng.uniform(1, 60, (2, 20, 2)).astype(np.float32)
    b2[:, ::2, 2:] = b2[:, ::2, :2] + rng.uniform(1, 60, (2, 25, 2)).astype(np.float32)
    j, t = _both(jgeo.pairwise_iou, tgeo.pairwise_iou, b1, b2)
    np.testing.assert_array_equal(t, j)
    assert (t >= 0).all() and (t > 0.1).any()
