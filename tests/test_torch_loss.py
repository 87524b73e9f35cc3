"""Port parity: the training loss (losses/loss.py) and the IoU loss family
(ops/geometry.py) against the jitted JAX functions.

Head outputs and padded targets (M = 32) from a seeded numpy generator at
128 px, B = 2, on the grid of tests/test_loss.py (use_dfl x reg_max x
iou_type), with ATSS and with TAL. The 7 loss items and the total agree
within rtol 1e-5 (the two frameworks sum the ~10^5-term reductions in other
orders). The gradients of the total w.r.t. every head output agree within
rtol 1e-4 plus an absolute 1e-6 of the largest gradient of that output: the
sigmoided scores are drawn from [0.001, 0.999], away from the ends where the
VFL's clip splits a tie's gradient in JAX and passes it whole in torch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.losses import loss as jloss
from yololp_tpu.models.effidehead import HeadTrainOutput as JOut
from yololp_tpu.ops import geometry as jgeo
from yololp_tpu_torch.losses import loss as tloss
from yololp_tpu_torch.models.effidehead import HeadTrainOutput as TOut
from yololp_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(2)

IMG = 128
STRIDES = (8, 16, 32)
M = 32
ITEM_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-6
IOU_TYPES = ("iou", "giou", "diou", "ciou", "siou")


def n_anchors():
    return sum((IMG // s) ** 2 for s in STRIDES)


def head_outputs(rng, bsz, reg_max=0):
    a = n_anchors()

    def sig(shape):
        return rng.uniform(0.001, 0.999, shape).astype(np.float32)

    return (sig((bsz, a, 31)), sig((bsz, a, 24)), sig((bsz, a, 6, 37)),
            rng.uniform(-2, 6, (bsz, a, 4 * (reg_max + 1))).astype(np.float32),
            rng.uniform(-4, 4, (bsz, a, 8)).astype(np.float32))


def targets(rng, counts):
    """Padded (B, M, 20) normalized labels and their (B, M) mask."""
    labels = np.zeros((len(counts), M, 20), np.float32)
    labels[..., :8] = -1
    mask = np.zeros((len(counts), M), np.float32)
    for b, n in enumerate(counts):
        for i in range(n):
            cxy = rng.uniform(0.2, 0.8, 2)
            wh = rng.uniform(0.08, 0.4, 2)
            (x1, y1), (x2, y2) = cxy - wh / 2, cxy + wh / 2
            labels[b, i, 0], labels[b, i, 1] = rng.integers(0, 31), rng.integers(0, 24)
            labels[b, i, 2:8] = rng.integers(0, 37, 6)
            labels[b, i, 8:12] = [*cxy, *wh]
            labels[b, i, 12:20] = [x1, y1, x1, y2, x2, y2, x2, y1]
            mask[b, i] = 1
    return labels, mask


def jax_loss_and_grads(outs, labels, mask, cfg):
    def total(*o):
        return jloss.compute_loss(JOut(None, *o), jnp.asarray(labels), jnp.asarray(mask), cfg)[0]

    t, items, fg = jloss.compute_loss(JOut(None, *map(jnp.asarray, outs)), jnp.asarray(labels),
                                      jnp.asarray(mask), cfg, with_fg=True)
    grads = jax.jit(jax.grad(total, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, outs))
    return float(t), np.asarray(items), np.asarray(fg), [np.asarray(g) for g in grads]


def torch_loss_and_grads(outs, labels, mask, cfg):
    leaves = [torch.from_numpy(o).requires_grad_(True) for o in outs]
    t, items, fg = tloss.compute_loss(TOut(None, *leaves), torch.from_numpy(labels),
                                      torch.from_numpy(mask), cfg, with_fg=True)
    t.backward()
    return float(t.detach()), items.numpy(), fg.numpy(), [x.grad.numpy() for x in leaves]


def assert_loss_matches(outs, labels, mask, jcfg, tcfg):
    jt, jitems, jfg, jgrads = jax_loss_and_grads(outs, labels, mask, jcfg)
    tt, titems, tfg, tgrads = torch_loss_and_grads(outs, labels, mask, tcfg)
    np.testing.assert_array_equal(tfg, jfg)
    np.testing.assert_allclose(tt, jt, rtol=ITEM_RTOL)
    np.testing.assert_allclose(titems, jitems, rtol=ITEM_RTOL, atol=1e-7)
    for name, g, w in zip(("pro", "alp", "ads", "reg", "cor"), tgrads, jgrads):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * np.abs(w).max(), err_msg=name)
    return jfg, jgrads


def cfgs(**kw):
    kw = dict(img_size=(IMG, IMG), strides=STRIDES, **kw)
    return jloss.LossConfig(**kw), tloss.LossConfig(**kw)


@pytest.mark.parametrize("use_dfl,reg_max,iou_type",
                         [(False, 0, "giou"), (False, 0, "siou"), (True, 16, "giou"),
                          (False, 0, "ciou"), (True, 8, "siou")])
def test_loss_and_gradients_match_jit(use_dfl, reg_max, iou_type):
    rng = np.random.default_rng(11 + reg_max)
    outs = head_outputs(rng, 2, reg_max)
    labels, mask = targets(rng, [5, 2])
    fg, grads = assert_loss_matches(outs, labels, mask,
                                    *cfgs(use_dfl=use_dfl, reg_max=reg_max, iou_type=iou_type))
    assert fg.sum() > 0 and all(np.abs(g).max() > 0 for g in grads[:3])


def test_loss_with_the_tal_assigner_matches_jit():
    rng = np.random.default_rng(12)
    outs = head_outputs(rng, 2)
    labels, mask = targets(rng, [3, 1])
    fg, _ = assert_loss_matches(outs, labels, mask, *cfgs(assigner="tal", iou_type="siou"))
    assert fg.sum() > 0


def test_loss_zero_gt_matches_jit_and_is_finite():
    """A batch without gts: the items and the total equal the JAX ones, and
    the port's gradient is finite. The JAX gradient is NaN there: its
    jnp.where(sum > 0, loss / sum, loss) differentiates the division by 0 of
    the branch not taken. The port divides by the selected denominator
    instead, which has the same value and the selected branch's gradient."""
    rng = np.random.default_rng(13)
    outs = head_outputs(rng, 2)
    labels, mask = targets(rng, [0, 0])
    jcfg, tcfg = cfgs()
    jt, jitems, jfg, jgrads = jax_loss_and_grads(outs, labels, mask, jcfg)
    tt, titems, tfg, tgrads = torch_loss_and_grads(outs, labels, mask, tcfg)
    assert not jfg.any() and not tfg.any()
    np.testing.assert_allclose(tt, jt, rtol=ITEM_RTOL)
    np.testing.assert_allclose(titems, jitems, rtol=ITEM_RTOL, atol=1e-7)
    assert all(np.isfinite(g).all() for g in tgrads)
    assert np.isnan(jgrads[0]).all()  # the reference's NaN, recorded in ROADMAP


@pytest.mark.parametrize("iou_type", IOU_TYPES)
def test_iou_loss_and_its_gradient_match_jit(iou_type):
    rng = np.random.default_rng(len(iou_type))
    cxy = rng.uniform(10, 50, (2, 300, 2))
    b1 = np.concatenate([cxy - rng.uniform(1, 9, (2, 300, 2)), cxy + rng.uniform(1, 9, (2, 300, 2))],
                        -1).astype(np.float32)
    b2 = (b1 + rng.normal(0, 3, b1.shape)).astype(np.float32)
    b2[..., 2:] = np.maximum(b2[..., 2:], b2[..., :2] + 0.5)
    f = jax.jit(lambda a, b: jgeo.iou_loss(a, b, iou_type=iou_type).sum())
    want = np.asarray(jax.jit(lambda a, b: jgeo.iou_loss(a, b, iou_type=iou_type))(b1, b2))
    want_g = np.asarray(jax.grad(f)(jnp.asarray(b1), jnp.asarray(b2)))
    t1 = torch.from_numpy(b1).requires_grad_(True)
    got = tgeo.iou_loss(t1, torch.from_numpy(b2), iou_type=iou_type)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t1.grad.numpy(), want_g, rtol=1e-4,
                               atol=GRAD_ATOL_FRAC * np.abs(want_g).max())
    xy = tgeo.xyxy2xywh(torch.from_numpy(b1))
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jgeo.xyxy2xywh(b1)))
    with pytest.raises(ValueError, match="iou_type"):
        tgeo.iou_loss(t1, t1, iou_type="eiou")


def test_codecs_vfl_wing_and_dfl_match_jit():
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 40, (50, 2)).astype(np.float32)
    box = np.concatenate([pts - rng.uniform(-1, 9, (50, 2)), pts + rng.uniform(-1, 9, (50, 2))],
                         -1).astype(np.float32)
    cor = rng.uniform(0, 40, (50, 8)).astype(np.float32)
    t = torch.from_numpy
    for reg_max in (8, 16):
        np.testing.assert_array_equal(tgeo.bbox2dist(t(pts), t(box), reg_max).numpy(),
                                      np.asarray(jax.jit(jgeo.bbox2dist, static_argnums=2)(
                                          pts, box, reg_max)))
        np.testing.assert_array_equal(tgeo.cor2dist(t(pts), t(cor), reg_max).numpy(),
                                      np.asarray(jax.jit(jgeo.cor2dist, static_argnums=2)(
                                          pts, cor, reg_max)))
    mmdet_j = jax.jit(jgeo.pairwise_iou_mmdet)(box[:7], box)
    np.testing.assert_array_equal(tgeo.pairwise_iou_mmdet(t(box[:7]), t(box)).numpy(),
                                  np.asarray(mmdet_j))

    pred = rng.uniform(0.001, 0.999, (2, 50, 31)).astype(np.float32)
    gt = (rng.uniform(0, 1, (2, 50, 31)) * rng.integers(0, 2, (2, 50, 31))).astype(np.float32)
    label = rng.integers(0, 2, (2, 50, 31)).astype(np.float32)
    np.testing.assert_allclose(float(tloss.varifocal_loss(t(pred), t(gt), t(label))),
                               float(jax.jit(jloss.varifocal_loss)(pred, gt, label)), rtol=1e-5)
    x = rng.uniform(-20, 20, (40, 8)).astype(np.float32)
    tt = rng.uniform(-20, 20, (40, 8)).astype(np.float32)
    tt[0, :3] = -1
    np.testing.assert_allclose(tloss.wing_loss(t(x), t(tt)).numpy(),
                               np.asarray(jax.jit(jloss.wing_loss)(x, tt)), rtol=1e-6, atol=1e-6)
    pd = rng.normal(0, 2, (3, 20, 4, 17)).astype(np.float32)
    tgt = rng.uniform(0, 15.99, (3, 20, 4)).astype(np.float32)
    np.testing.assert_allclose(tloss._df_loss(t(pd), t(tgt), 16).numpy(),
                               np.asarray(jax.jit(jloss._df_loss, static_argnums=2)(pd, tgt, 16)),
                               rtol=1e-5, atol=1e-6)
