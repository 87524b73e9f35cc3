"""Port parity: the train step (forward, loss, backward, SGD, EMA, gradient
accumulation) against the jitted JAX `make_train_step`, as
tests/test_train_step.py drives it.

yololpn at 128 px, batch 2, every parameter and BN statistic drawn from a
seed and carried into the port; the port runs in fp32. The batches hold gts
(on a batch without any, the JAX loss's gradient is NaN: ROADMAP C).

Each micro-step runs from one state in both: the port's step, and the JAX
step from the port's state before it (so that no difference compounds).

The reference. In fp32 the jitted JAX backward of the train-mode backbone
is numerically poor: its gradients differ from the same program's float64
evaluation by up to 31% of a tensor's largest gradient (ERBlock_5's SPPF;
4% eager, so most of it is XLA's rewrites of the jitted program), while the
port's fp32 gradients are within 2e-5 of float64 and the two packages agree
to 6e-8 in float64 (measured on this model and batch; ROADMAP C). So the
steps are held against the jitted JAX train step run in float64
(`jax.enable_x64`, the model's dtype float64, the state cast to float64;
the schedule and the loss's own casts stay fp32, as the program has them).
The fp32 loss of the port and of JAX agree to ~1e-6 (tests/test_torch_loss.py
and test_torch_train_head.py hold the fp32 forward).

Tolerances: the loss total and items of each step within rtol 1e-3 (they
agree to ~1e-6). The parameters, momentum, EMA and gradient buffer are
compared as updates over the step: each tensor's update within 2e-2 of that
tensor's largest update, plus 1e-6 of its values' magnitude and 1e-4 of the
largest update of any tensor. fp32's error in a backward sum is relative to
the sum's terms, not to its result: where a tensor's gradient is tiny
against the rest (a bias feeding a train-mode BN through a linear map has a
zero gradient in exact arithmetic; a near-dead path), fp32 leaves noise of
the whole backward's scale. The port's own fp32 gradients differ from its
float64 ones by up to 5e-5 of the largest gradient on these batches
(measured), 2e-5 relative on the tensors that carry the gradient. The BN statistics within rtol 1e-3 +
5e-3. The accumulation gating (which micro-steps step the optimizer,
ema_updates, step, last_opt_step) is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_layers import randomize_variables
from yololp_tpu.core import train_step as jts
from yololp_tpu.losses.loss import LossConfig as JLossConfig
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.solver.build import SolverConfig as JSolverConfig
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.core import train_step as tts
from yololp_tpu_torch.losses.loss import LossConfig
from yololp_tpu_torch.models.yolo import Model, build_model
from yololp_tpu_torch.solver.build import SolverConfig
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict, state_dict_to_jax

torch.set_num_threads(4)

IMG = 128
LOSS_RTOL = 1e-3
UPDATE_TOL, VALUE_TOL, GLOBAL_TOL = 2e-2, 1e-6, 1e-4


def fast_jax_variables(name, seed):
    """Randomized train-format JAX variables of a named config, as
    test_torch_models.jax_variables makes them, with the tree taken from the
    port's model (utils/convert.py; the same tree, without compiling the
    JAX init)."""
    model = build_model(Config.named(name), seed=0, device="cpu")
    return randomize_variables(state_dict_to_jax(model.state_dict()), seed)


def synthetic_batch(rng, bsz=2, n=2, img=IMG):
    """Images with bright plate-shaped rectangles and their labels (the JAX
    test's batch)."""
    imgs = rng.integers(0, 80, (bsz, img, img, 3), np.uint8)
    labels = np.zeros((bsz, n, 20), np.float32)
    labels[..., :8] = -1
    mask = np.zeros((bsz, n), np.float32)
    for b in range(bsz):
        for i in range(n):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.2, 0.3), rng.uniform(0.1, 0.15)
            x1, y1 = int((cx - w / 2) * img), int((cy - h / 2) * img)
            x2, y2 = int((cx + w / 2) * img), int((cy + h / 2) * img)
            imgs[b, y1:y2, x1:x2] = 220
            labels[b, i, 0] = rng.integers(0, 31)
            labels[b, i, 1] = rng.integers(0, 24)
            labels[b, i, 2:8] = rng.integers(0, 37, 6)
            labels[b, i, 8:12] = [cx, cy, w, h]
            labels[b, i, 12:20] = [cx - w / 2, cy - h / 2, cx - w / 2, cy + h / 2,
                                   cx + w / 2, cy + h / 2, cx + w / 2, cy - h / 2]
            mask[b, i] = 1
    return imgs, labels, mask


# the JAX test's solver with a gentler first bias lr: at warmup_bias_lr 0.1
# one step moves the loss of this random net by ~15%, and the fp32 rounding
# of the port's gradients (2e-5 against float64) grows to ~2% of the loss by
# the third step; at 0.01 it stays below 1e-4
SOLVER = dict(lr0=0.02, epochs=10, steps_per_epoch=10, warmup_epochs=0.0, warmup_bias_lr=0.01)
# batch 32: the accumulation count is 1 at the start of warmup (every step
# steps) and 2 past it (the gating test)
BATCH = 32


def flat(tree):
    """A flax tree (params-shaped or {'params', 'batch_stats'}) -> {port name: array}."""
    tree = jax.device_get(tree)
    if "params" not in tree:
        tree = {"params": tree}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    return {k: v.numpy() for k, v in jax_to_state_dict(tree).items()}


def state_arrays(state, which):
    names = state.names + state.stat_names if which != "momentum" else state.names
    tensors = {"params": state.params + state.batch_stats, "ema": state.ema_params + state.ema_stats,
               "momentum": state.momentum}[which]
    return {n: t.detach().numpy().copy() for n, t in zip(names, tensors)}


def assert_updates_close(got, want, start, what):
    def update(k, a):
        return a - start.get(k, np.zeros_like(a))

    floor = GLOBAL_TOL * max(np.abs(update(k, w)).max() for k, w in want.items())
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=5e-3, err_msg=f"{what} {k}")
            continue
        du_w, du_g = update(k, w), update(k, got[k])
        tol = UPDATE_TOL * np.abs(du_w).max() + VALUE_TOL * np.abs(w).max() + floor
        assert np.abs(du_g - du_w).max() <= tol, (what, k, np.abs(du_g - du_w).max(), tol)


def jax_step_fn(dt):
    return jax.jit(jts.make_train_step(
        JModel(JConfig.named("yololpn"), dtype=dt), JLossConfig(img_size=(IMG, IMG), iou_type="siou"),
        JSolverConfig(**SOLVER), batch_size=BATCH))


@pytest.fixture(scope="module")
def setup():
    variables = fast_jax_variables("yololpn", seed=23)
    rng = np.random.default_rng(5)
    batches = [synthetic_batch(rng) for _ in range(3)]
    with jax.enable_x64(True):
        step64 = jax_step_fn(jnp.float64)
    return variables, batches, step64


def jax_state(tstate):
    """The port's TrainState as a float64 JAX TrainState."""
    def tree(names, tensors, stats_names=(), stats=()):
        sd = {n: t.detach() for n, t in zip(list(names) + list(stats_names), list(tensors) + list(stats))}
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), state_dict_to_jax(sd))

    v = tree(tstate.names, tstate.params, tstate.stat_names, tstate.batch_stats)
    e = tree(tstate.names, tstate.ema_params, tstate.stat_names, tstate.ema_stats)
    return jts.TrainState(
        params=v["params"], batch_stats=v["batch_stats"],
        momentum=tree(tstate.names, tstate.momentum)["params"],
        grad_accum=tree(tstate.names, tstate.grad_accum)["params"],
        ema_params=e["params"], ema_stats=e["batch_stats"],
        ema_updates=jnp.asarray(tstate.ema_updates, jnp.int32),
        step=jnp.asarray(tstate.step, jnp.int32),
        last_opt_step=jnp.asarray(tstate.last_opt_step, jnp.int32))


def run_steps(setup, batches, start_step=0, last_opt_step=None):
    """Each micro-step from the same state: the port's step, and the float64
    JAX step from the port's state before it; the outputs and the new
    states compared. Returns the counts after each step."""
    variables, _, step64 = setup
    model = load_state_dict_strict(Model(Config.named("yololpn")), jax_to_state_dict(variables))
    state = tts.init_train_state(model)
    if last_opt_step is not None:
        state.step, state.last_opt_step = start_step, last_opt_step
    step_fn = tts.make_train_step(model, LossConfig(img_size=(IMG, IMG), iou_type="siou"),
                                  SolverConfig(**SOLVER), batch_size=BATCH)
    counts = []
    for imgs, labels, mask in batches:
        with jax.enable_x64(True):
            js, jt, ji = step64(jax_state(state), jnp.asarray(imgs), jnp.asarray(labels),
                                jnp.asarray(mask))
            js, jt, ji = jax.device_get((js, jt, ji))
        start = {w: state_arrays(state, w) for w in ("params", "ema", "momentum")}
        state, total, items = step_fn(state, imgs, labels, mask)
        assert np.isfinite(float(total)) and torch.isfinite(items).all()
        np.testing.assert_allclose(float(total), float(jt), rtol=LOSS_RTOL)
        np.testing.assert_allclose(items.numpy(), np.asarray(ji, np.float32), rtol=LOSS_RTOL,
                                   atol=1e-7)
        count = (state.ema_updates, state.step, state.last_opt_step)
        assert count == (int(js.ema_updates), int(js.step), int(js.last_opt_step))
        counts.append(count)
        assert_updates_close(state_arrays(state, "params"),
                             flat({"params": js.params, "batch_stats": js.batch_stats}),
                             start["params"], "params")
        assert_updates_close(state_arrays(state, "momentum"), flat(js.momentum),
                             start["momentum"], "momentum")
        assert_updates_close(state_arrays(state, "ema"),
                             flat({"params": js.ema_params, "batch_stats": js.ema_stats}),
                             start["ema"], "ema")
        assert_updates_close({n: g.numpy() for n, g in zip(state.names, state.grad_accum)},
                             flat(js.grad_accum), {}, "gradient buffer")
    return counts


def test_three_steps_match_jit(setup):
    counts = run_steps(setup, setup[1])
    assert counts == [(1, 1, 0), (2, 2, 1), (3, 3, 2)]  # accumulate 1 early in warmup


def test_accumulation_gating_matches_jit(setup):
    """Past warmup at batch 32 the nominal accumulation is 2: from step 1001
    with the last optimizer step at 1000, step 1001 only accumulates (the
    gradient buffer holds its gradient), step 1002 applies the sum of both
    micro-steps' gradients and zeroes the buffer."""
    counts = run_steps(setup, setup[1][:2], start_step=1001, last_opt_step=1000)
    assert counts == [(0, 1002, 1000), (1, 1003, 1002)]
