"""Port parity: ATSS and TAL label assignment against the jitted JAX
functions (`atss_assign` and `tal_assign` are jitted in the JAX package).

Scenes from a seeded numpy generator at 128-320 px, gts padded to M = 32 with
a mask, B = 2-4. Every field is compared element for element: class ids,
boxes, corners, the fg mask and the score tensors exactly for ATSS. TAL's
align metric raises IoUs to the 6th power; XLA's CPU pow is an approximation
of its own, and the port's power (fp64, rounded once, the same on the card)
differs from it in the last bit on ~0.06% of values, so TAL's score tensors
are held to rtol 1e-6 and everything else exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.assigners import atss as jatss
from yololp_tpu.assigners import tal as jtal
from yololp_tpu.ops.anchors import anchors_train as janchors
from yololp_tpu_torch.assigners import atss as tatss
from yololp_tpu_torch.assigners import tal as ttal
from yololp_tpu_torch.ops.anchors import anchors_train

STRIDES = (8, 16, 32)
M = 32
FIELDS = ("target_pro", "target_alp", "target_ads", "target_bboxes", "target_corners",
          "target_pro_scores", "target_alp_scores", "target_ads_scores", "fg_mask")


def make_scene(rng, bsz, img, counts, m=M):
    """Padded gts in pixels: `counts[b]` real gts of image b (class slots -1
    and coords 0 in the padding)."""
    gt_pro = np.full((bsz, m), -1, np.float32)
    gt_alp = np.full((bsz, m), -1, np.float32)
    gt_ads = np.full((bsz, m, 6), -1, np.float32)
    gt_bboxes = np.zeros((bsz, m, 4), np.float32)
    gt_corners = np.zeros((bsz, m, 8), np.float32)
    mask = np.zeros((bsz, m, 1), np.float32)
    for b, n in enumerate(counts):
        cxy = rng.uniform(img * 0.2, img * 0.8, (n, 2))
        wh = rng.uniform(img * 0.1, img * 0.4, (n, 2))
        box = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
        gt_bboxes[b, :n] = box
        gt_corners[b, :n] = box[:, [0, 1, 0, 3, 2, 3, 2, 1]]
        gt_pro[b, :n] = rng.integers(0, 31, n)
        gt_alp[b, :n] = rng.integers(0, 24, n)
        gt_ads[b, :n] = rng.integers(0, 37, (n, 6))
        mask[b, :n] = 1
    return gt_pro, gt_alp, gt_ads, gt_bboxes, gt_corners, mask


def random_preds(rng, bsz, img):
    _, points, _, st = janchors((img, img), STRIDES)
    a = points.shape[0]
    half = rng.uniform(0.5, 4.0, (bsz, a, 2)) * np.asarray(st)
    ctr = np.asarray(points)[None] + rng.normal(0, 4, (bsz, a, 2))
    pd = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    scores = rng.uniform(0.001, 0.999, (bsz, a, 31)).astype(np.float32)
    return pd, scores


def assert_fields(got, want, score_rtol=0.0):
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name.endswith("_scores") and score_rtol:
            np.testing.assert_allclose(g, w, rtol=score_rtol, atol=0, err_msg=name)
        else:
            if name == "fg_mask":
                assert g.dtype == np.bool_
            else:
                assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def run_atss(img, scene, pd):
    anchors_j, _, n_list, _ = janchors((img, img), STRIDES)
    anchors_t, _, n_list_t, _ = anchors_train((img, img), STRIDES)
    np.testing.assert_array_equal(anchors_t.numpy(), np.asarray(anchors_j))
    assert n_list_t == n_list
    want = jatss.atss_assign(anchors_j, tuple(n_list), *map(jnp.asarray, scene),
                             None if pd is None else jnp.asarray(pd))
    got = tatss.atss_assign(anchors_t, tuple(n_list), *map(torch.from_numpy, scene),
                            None if pd is None else torch.from_numpy(pd))
    return got, want


@pytest.mark.parametrize("img,bsz,counts,with_pd", [
    (128, 2, (5, 1), True), (128, 2, (5, 1), False), (320, 4, (3, 32, 0, 12), True),
    (160, 3, (8, 8, 8), True)])
def test_atss_matches_jit(img, bsz, counts, with_pd):
    rng = np.random.default_rng(img + bsz)
    scene = make_scene(rng, bsz, img, counts)
    pd = random_preds(rng, bsz, img)[0] if with_pd else None
    got, want = run_atss(img, scene, pd)
    assert_fields(got, want)
    assert got.fg_mask.sum() > 0


def test_atss_all_padded_gts_is_all_background():
    scene = make_scene(np.random.default_rng(0), 2, 128, (0, 0))
    pd = random_preds(np.random.default_rng(1), 2, 128)[0]
    got, want = run_atss(128, scene, pd)
    assert_fields(got, want)
    assert not got.fg_mask.any() and (got.target_pro == 31).all() and (got.target_ads == 37).all()
    assert got.target_pro_scores.sum() == 0


def test_atss_distance_ties_go_to_the_lower_index():
    """A gt centred on a grid corner: its 4 nearest anchor centres of every
    level are at one distance, and more tie further out. The candidates
    (is_in_candidate and candidate_idxs, in order) equal lax.top_k's."""
    img = 128
    scene = make_scene(np.random.default_rng(2), 2, img, (2, 1))
    gt_bboxes = scene[3]
    gt_bboxes[0, 0] = [48, 48, 80, 80]        # centre (64, 64): a corner of every level's grid
    gt_bboxes[0, 1] = [16, 40, 48, 56]        # centre (32, 48)
    gt_bboxes[1, 0] = [60, 30, 100, 50]       # centre (80, 40)
    anchors_j, _, n_list, _ = janchors((img, img), STRIDES)
    anchors_t = anchors_train((img, img), STRIDES)[0]
    d_j, _ = jatss._center_distances(jnp.asarray(gt_bboxes), anchors_j)
    lvl0 = np.asarray(d_j)[0, 0, :n_list[0]]
    assert (lvl0 == lvl0.min()).sum() == 4  # a 4-way tie at the nearest distance
    import jax

    want = jax.jit(jatss._select_topk_candidates, static_argnums=(1, 3))(
        d_j, tuple(n_list), jnp.asarray(scene[5]), 9)
    d_t, _ = tatss._center_distances(torch.from_numpy(gt_bboxes), anchors_t)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    got = tatss._select_topk_candidates(d_t, tuple(n_list), torch.from_numpy(scene[5]), 9)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    got_a, want_a = run_atss(img, scene, random_preds(np.random.default_rng(3), 2, img)[0])
    assert_fields(got_a, want_a)


def test_atss_threshold_matches_jit():
    """mean + std(ddof=1) of the candidates: the left-to-right sums and the
    reciprocal multiplies of the jitted program. Where XLA fuses the mean
    into the variance loop it contracts multiply-adds into FMAs, which the
    port does not: the threshold may then differ in its last two bits, and
    never by more."""
    import jax

    rng = np.random.default_rng(4)
    b, m, a, k = 2, M, 2000, 27
    ov = (rng.random((b, m, a)) * 0.6).astype(np.float32)
    isin = (rng.random((b, m, a)) < 0.3).astype(np.float32)
    idx = np.stack([rng.choice(a, k, replace=False) for _ in range(b * m)]).reshape(b, m, k)
    want_thr, want_mo = jax.jit(jatss._threshold)(jnp.asarray(isin), jnp.asarray(idx),
                                                  jnp.asarray(ov))
    got_thr, got_mo = tatss._threshold(torch.from_numpy(isin), torch.from_numpy(idx),
                                       torch.from_numpy(ov))
    np.testing.assert_array_equal(got_mo.numpy(), np.asarray(want_mo))
    w = np.asarray(want_thr)
    assert (np.abs(got_thr.numpy() - w) <= 2 * np.spacing(w)).all()
    cand = np.take_along_axis(np.where(isin > 0, ov, 0), idx, -1)
    np.testing.assert_array_equal(
        tatss._sum_in_order(torch.from_numpy(cand)).numpy()[..., 0] * np.float32(1 / 27),
        np.asarray(jax.jit(lambda c: c.sum(-1))(jnp.asarray(cand))) * np.float32(1 / 27))


def run_tal(img, scene, pd, scores, **kw):
    _, points_j, _, _ = janchors((img, img), STRIDES)
    _, points_t, _, _ = anchors_train((img, img), STRIDES)
    want = jtal.tal_assign(jnp.asarray(scores), jnp.asarray(pd), points_j,
                           *map(jnp.asarray, scene), **kw)
    got = ttal.tal_assign(torch.from_numpy(scores), torch.from_numpy(pd), points_t,
                          *map(torch.from_numpy, scene), **kw)
    return got, want


@pytest.mark.parametrize("img,bsz,counts", [(128, 2, (5, 1)), (160, 4, (3, 32, 0, 12))])
def test_tal_matches_jit(img, bsz, counts):
    rng = np.random.default_rng(img * bsz)
    scene = make_scene(rng, bsz, img, counts)
    pd, scores = random_preds(rng, bsz, img)
    got, want = run_tal(img, scene, pd, scores)
    assert_fields(got, want, score_rtol=1e-6)
    assert got.fg_mask.sum() > 0


def test_tal_center_anchor_and_all_padded():
    """tests/test_tal.py's centre-anchor scene (every pred the gt box, every
    score 0.5: the align metric ties across anchors), and all-padded gts."""
    img = 160
    scene = make_scene(np.random.default_rng(5), 1, img, (1,))
    scene[0][0, 0], scene[1][0, 0] = 5, 3
    scene[2][0, 0] = [1, 2, 3, 4, 5, 36]
    scene[3][0, 0] = [40, 40, 120, 90]
    a = sum((img // s) ** 2 for s in STRIDES)
    pd = np.tile(scene[3][0, 0], (1, a, 1)).astype(np.float32)
    scores = np.full((1, a, 31), 0.5, np.float32)
    got, want = run_tal(img, scene, pd, scores)
    assert_fields(got, want, score_rtol=1e-6)
    assert got.fg_mask.sum() == 13
    empty = make_scene(np.random.default_rng(6), 2, img, (0, 0))
    pd2, scores2 = random_preds(np.random.default_rng(7), 2, img)
    got, want = run_tal(img, empty, pd2, scores2)
    assert_fields(got, want)
    assert not got.fg_mask.any()


def test_tal_covers_the_atss_dead_band():
    """tests/test_tal.py: plate-aspect boxes 100-115 px wide at 320 get fg
    anchors from TAL and none from ATSS, in the port as in JAX."""
    img = 320
    anchors, pts, n_level, st = anchors_train((img, img), STRIDES)
    a = pts.shape[0]
    scores = torch.from_numpy(np.random.default_rng(0).uniform(0, 0.3, (1, a, 31)).astype(np.float32))
    half = st * 2.5
    pd = torch.cat([pts - half, pts + half], -1)[None]
    z = torch.zeros
    for wpx in (100, 105, 110, 115):
        h = wpx / (272 / 72.0)
        bb = torch.tensor([[[163.0 - wpx / 2, 157.0 - h / 2, 163.0 + wpx / 2, 157.0 + h / 2]]])
        res_tal = ttal.tal_assign(scores, pd, pts, z(1, 1), z(1, 1), z(1, 1, 6), bb, z(1, 1, 8),
                                  torch.ones(1, 1, 1))
        res_atss = tatss.atss_assign(anchors, tuple(n_level), z(1, 1), z(1, 1), z(1, 1, 6), bb,
                                     z(1, 1, 8), torch.ones(1, 1, 1), None)
        assert res_tal.fg_mask.sum() > 0 and res_atss.fg_mask.sum() == 0, wpx
