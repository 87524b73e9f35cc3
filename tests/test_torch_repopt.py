"""Port parity: RepOpt (solver/repopt.py), the masked SGD step and a RepOpt
train step, against yololp_tpu.solver.repopt and the jitted JAX step.

Scales, re-initialization (given the 1x1 kernels drawn as the JAX function
draws them) and gradient masks are exact. The masked SGD update is held
against the jitted JAX update to 2 ulps, as tests/test_torch_solver.py holds
the unmasked one (XLA contracts its multiply-adds into FMAs; the mask's
`g * mask` is exact in both). The train
step of yolov6n_opt (narrow as configured: width 0.25, depth 0.33) at
128 px, batch 2, is held against the jitted JAX step in float64 with the
bounds of tests/test_torch_train_step.py, for the reasons given there.
"""

import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_solver import assert_close_ulps
from test_torch_train_step import (BATCH, IMG, LOSS_RTOL, SOLVER, assert_updates_close, flat,
                                   jax_state, state_arrays, synthetic_batch)
from test_torch_zoo import FAMILIES, check_family, random_jax_variables
from yololp_tpu.core import train_step as jts
from yololp_tpu.losses.loss import LossConfig as JLossConfig
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.solver import build as jbuild
from yololp_tpu.solver import repopt as jrepopt
from yololp_tpu.solver.build import SolverConfig as JSolverConfig
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.core import train_step as tts
from yololp_tpu_torch.losses.loss import LossConfig
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.solver import build as tbuild
from yololp_tpu_torch.solver import repopt as trepopt
from yololp_tpu_torch.solver.build import SolverConfig
from yololp_tpu_torch.utils.checkpoint import save_checkpoint
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(4)


@pytest.mark.parametrize("family", ["yolov6_tiny_hs", "yolov6n_opt"])
def test_repopt_family_matches_flax(family):
    """The hyper-search and RepOpt families, as tests/test_torch_zoo.py
    holds the others."""
    check_family(*FAMILIES[family])


@pytest.fixture(scope="module")
def trees():
    """(hyper-search variables, yolov6n_opt variables, scales), seeded."""
    hs = random_jax_variables(Model(Config.named("repopt/yolov6n_hs")), 3)
    opt = random_jax_variables(Model(Config.named("repopt/yolov6n_opt")), 4)
    return hs, opt, jrepopt.extract_scales(hs["params"])


def _kernels_1x1_as_jax_draws(params, n, key):
    """The fresh 1x1 kernels JAX's reinitialize draws, OIHW."""
    keys = jax.random.split(key, n)
    out = []
    for path, k in zip(jrepopt._realvgg_conv_paths(params), keys):
        in_ch, out_ch = jrepopt._get(params, path).shape[2:]
        bound = 1.0 / np.sqrt(in_ch)
        w = jax.random.uniform(k, (1, 1, in_ch, out_ch), jnp.float32, -bound, bound)
        out.append(torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy()))
    return out


def test_scales_in_flax_tree_order(trees):
    hs, _, want = trees
    model = load_state_dict_strict(Model(Config.named("repopt/yolov6n_hs")),
                                   jax_to_state_dict(hs))
    got = trepopt.extract_scales(model.state_dict())
    assert len(got) == len(want) > 10 and {len(s) for s in got} == {2, 3}
    for a, b in zip(got, want):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    # registration order is another order: pairing by it would mismatch
    blocks = [n for n, m in model.named_modules() if type(m).__name__ == "LinearAddBlock"]
    assert blocks != sorted(blocks, key=lambda n: n.split("."))


def test_reinitialize_and_masks_exact(trees):
    _, opt, scales = trees
    key = jax.random.PRNGKey(11)
    # eager, as the JAX engine calls them (under jit XLA contracts the
    # kernel's multiply-adds into FMAs)
    want = jrepopt.reinitialize(opt["params"], scales, key)
    want_masks = jrepopt.gradient_masks(want, scales)
    sd = jax_to_state_dict(opt)
    keys = trepopt.realvgg_conv_keys(sd)
    k1 = _kernels_1x1_as_jax_draws(opt["params"], len(keys), key)
    new = trepopt.reinitialize(sd, scales, kernels_1x1=k1)
    want_sd = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want)})
    assert set(new) == set(keys)
    for k in keys:
        assert torch.equal(new[k], want_sd[k]), k
    masks = trepopt.gradient_masks(sd, scales)
    assert set(masks) == set(keys)
    for k in keys:
        want_m = np.asarray(jrepopt._get(want_masks, tuple(k.split(".")[:-1]) + ("kernel",)))
        assert np.array_equal(masks[k].numpy(), want_m.transpose(3, 2, 0, 1)), k
    # a drawn 1x1 (no kernels given) follows torch's Conv2d default bound
    drawn = trepopt.reinitialize(sd, scales, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in drawn.values())


@pytest.mark.parametrize("use_identity_scales", [True, False])
def test_reinitialize_identity_scales_equal_jax(trees, use_identity_scales):
    """JAX's use_identity_scales=False adds the plain identity to the blocks
    with an identity branch in place of identity times its scale."""
    _, opt, scales = trees
    key = jax.random.PRNGKey(12)
    want = jrepopt.reinitialize(opt["params"], scales, key,
                                use_identity_scales=use_identity_scales)
    sd = jax_to_state_dict(opt)
    keys = trepopt.realvgg_conv_keys(sd)
    new = trepopt.reinitialize(sd, scales, use_identity_scales=use_identity_scales,
                               kernels_1x1=_kernels_1x1_as_jax_draws(opt["params"], len(keys), key))
    want_sd = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want)})
    for k in keys:
        assert torch.equal(new[k], want_sd[k]), k
    scaled = trepopt.reinitialize(sd, scales, kernels_1x1=_kernels_1x1_as_jax_draws(
        opt["params"], len(keys), key))
    # the setting matters exactly on the blocks with an identity branch
    assert [not torch.equal(new[k], scaled[k]) for k in keys] == [
        len(sc) == 3 and not use_identity_scales for sc in scales]


def test_scales_files_interchange(tmp_path, trees):
    hs, _, scales = trees
    jrepopt.save_scales(scales, str(tmp_path / "jax.msgpack"))
    trepopt.save_scales(trepopt.extract_scales(jax_to_state_dict(hs)), str(tmp_path / "t.msgpack"))
    # a hyper-search checkpoint the port writes: its EMA's scales
    save_checkpoint({"format": "train", "variables": hs, "ema": hs}, str(tmp_path / "hs.msgpack"))
    for loaded in (trepopt.load_scales(str(tmp_path / "jax.msgpack")),
                   jrepopt.load_scales(str(tmp_path / "t.msgpack")),
                   trepopt.load_scales(str(tmp_path / "hs.msgpack")),
                   jrepopt.load_scales(str(tmp_path / "hs.msgpack"))):
        assert len(loaded) == len(scales)
        for a, b in zip(loaded, scales):
            assert all(np.array_equal(np.asarray(x), y) for x, y in zip(a, b))
    with pytest.raises(FileNotFoundError, match="nope.msgpack"):
        trepopt.load_scales(str(tmp_path / "nope.msgpack"))


def test_masked_sgd_apply_matches_jax(trees):
    _, opt, scales = trees
    params = jrepopt.reinitialize(opt["params"], scales, jax.random.PRNGKey(1))
    masks = jrepopt.gradient_masks(params, scales)
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                   params)
    vel = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                 params)
    lr_w, lr_b, mom = np.float32(0.01), np.float32(0.05), np.float32(0.9)
    labels = jbuild.label_tree(params)
    want_p, want_v = jax.jit(lambda p, g, v, m: jbuild.sgd_apply(
        p, g, v, labels, lr_w, lr_b, mom, 5e-4, grad_masks=m))(params, grads, vel, masks)
    model = load_state_dict_strict(Model(Config.named("repopt/yolov6n_opt")),
                                   jax_to_state_dict({"params": params,
                                                      "batch_stats": opt["batch_stats"]}))
    names = [n for n, _ in model.named_parameters()]
    p = [t.detach().clone() for _, t in model.named_parameters()]
    g_sd = jax_to_state_dict({"params": grads})
    v_sd = jax_to_state_dict({"params": vel})
    g, v = [g_sd[n] for n in names], [v_sd[n].clone() for n in names]
    tm = trepopt.gradient_masks(dict(zip(names, p)), scales)
    labels = [tbuild.label_groups(model)[n] for n in names]
    tbuild.sgd_apply(p, g, v, labels, lr_w, lr_b, mom, 5e-4, grad_masks=[tm.get(n) for n in names])
    wp = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want_p)})
    wv = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want_v)})
    masked = set(tm)
    assert masked and masked < set(names)
    for i, n in enumerate(names):
        assert_close_ulps(p[i].numpy(), wp[n].numpy(), n)
        assert_close_ulps(v[i].numpy(), wv[n].numpy(), n)


def test_repopt_train_step_matches_jit(trees):
    """One step of yolov6n_opt after reinit, with masks, from one state in
    both: the port in fp32, JAX jitted in float64."""
    _, opt, scales = trees
    name = "repopt/yolov6n_opt"
    key = jax.random.PRNGKey(5)
    params = jrepopt.reinitialize(opt["params"], scales, key)
    jmasks = jrepopt.gradient_masks(params, scales)
    model = load_state_dict_strict(Model(Config.named(name)), jax_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params), "batch_stats": opt["batch_stats"]}))
    masks = trepopt.gradient_masks(dict(model.named_parameters()), scales)
    state = tts.init_train_state(model)
    step_fn = tts.make_train_step(model, LossConfig(img_size=(IMG, IMG), iou_type="siou"),
                                  SolverConfig(**SOLVER), batch_size=BATCH, grad_masks=masks)
    imgs, labels, mask = synthetic_batch(np.random.default_rng(zlib.crc32(name.encode())))
    with jax.enable_x64(True):
        jstep = jax.jit(jts.make_train_step(
            JModel(JConfig.named(name), dtype=jnp.float64),
            JLossConfig(img_size=(IMG, IMG), iou_type="siou"), JSolverConfig(**SOLVER),
            batch_size=BATCH, grad_masks=jmasks))
        js, jt, ji = jax.device_get(jstep(jax_state(state), jnp.asarray(imgs),
                                          jnp.asarray(labels), jnp.asarray(mask)))
    start = {w: state_arrays(state, w) for w in ("params", "ema", "momentum")}
    state, total, items = step_fn(state, imgs, labels, mask)
    np.testing.assert_allclose(float(total), float(jt), rtol=LOSS_RTOL)
    np.testing.assert_allclose(items.numpy(), np.asarray(ji, np.float32), rtol=LOSS_RTOL, atol=1e-7)
    assert (state.ema_updates, state.step, state.last_opt_step) == (
        int(js.ema_updates), int(js.step), int(js.last_opt_step)) == (1, 1, 0)
    assert_updates_close(state_arrays(state, "params"),
                         flat({"params": js.params, "batch_stats": js.batch_stats}),
                         start["params"], "params")
    assert_updates_close(state_arrays(state, "momentum"), flat(js.momentum),
                         start["momentum"], "momentum")


def test_csla_equivalence_one_step():
    """RepOpt's defining property on the port's functions: one SGD step on
    the CSLA branches (W3 scaled by s_c, W1 by s_1), merged after, equals one
    step on the merged kernel with the port's gradient mask."""
    rng = np.random.default_rng(5)
    c = 4
    w3 = torch.from_numpy(rng.normal(size=(c, c, 3, 3)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(c, c, 1, 1)).astype(np.float32))
    s_c, s_1 = (rng.uniform(0.5, 1.5, c).astype(np.float32) for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(2, c, 8, 8)).astype(np.float32))
    target = torch.from_numpy(rng.normal(size=(2, c, 8, 8)).astype(np.float32))
    col = lambda s: torch.from_numpy(s).reshape(-1, 1, 1, 1)  # noqa: E731
    lr = 0.01

    b3, b1 = w3.clone().requires_grad_(True), w1.clone().requires_grad_(True)
    y = F.conv2d(x, b3 * col(s_c), padding=1) + F.conv2d(x, b1 * col(s_1))
    ((y - target) ** 2).sum().backward()
    key = "blk.cell.conv.weight"
    merged_after = trepopt.reinitialize({key: w3 - lr * b3.grad}, [(s_1, s_c)],
                                        kernels_1x1=[w1 - lr * b1.grad])[key]

    w = trepopt.reinitialize({key: w3}, [(s_1, s_c)], kernels_1x1=[w1])[key].requires_grad_(True)
    ((F.conv2d(x, w, padding=1) - target) ** 2).sum().backward()
    mask = trepopt.gradient_masks({key: w3}, [(s_1, s_c)])[key]
    torch.testing.assert_close(w.detach() - lr * w.grad * mask, merged_after, rtol=1e-4, atol=1e-4)
