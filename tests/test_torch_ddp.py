"""Data-parallel training on 2 gloo ranks on the CPU, held against one
process on the global batch: synced BN, the loss with global denominators
(one rank holding no ground truth), the train step with DDP (3 steps, with
and without gradient accumulation), one step against the jitted JAX step,
and a --cache-device epoch.

The ranks are subprocesses (tests/_torch_dist_worker.py), each with its own
communicate() timeout and a 60 s process-group timeout, so that a
desynchronized run fails in seconds. Everything runs in float64, so that
the two sides differ by summation order alone: outputs, gradients and
loss items within 1e-10 relative (BN: 1e-12); the train state after 3
steps within 1e-8 of each tensor's largest value, plus 1e-12 of the
largest of any (a bias that feeds a train-mode BN has a zero gradient in
exact arithmetic and carries only rounding). The JAX comparison uses
tests/test_torch_train_step.py's tolerances (the JAX program under a mesh
computes its single-device function: tests/test_multihost.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from _torch_dist_worker import (Ranks, cached_epoch, case_bn, case_loss, run_ranks, run_steps,
                                train_model)
from test_torch_train_step import assert_updates_close, fast_jax_variables, flat, jax_state
from yololp_tpu.core import train_step as jts
from yololp_tpu.losses.loss import LossConfig as JLossConfig
from yololp_tpu.models.yolo import Model as JModel
from yololp_tpu.solver.build import SolverConfig as JSolverConfig
from yololp_tpu.utils.config import Config as JConfig
from yololp_tpu_torch.core import train_step as tts
from yololp_tpu_torch.losses.loss import LossConfig, compute_loss
from yololp_tpu_torch.models.effidehead import HeadTrainOutput
from yololp_tpu_torch.solver.build import SolverConfig
from yololp_tpu_torch.utils.convert import jax_to_state_dict

torch.set_num_threads(2)

IMG, BATCH = 64, 8  # global batch: 4 a rank on 2 ranks
SOLVER = dict(lr0=0.02, epochs=10, steps_per_epoch=10, warmup_epochs=0.0, warmup_bias_lr=0.01)
# (step, last_opt_step): early in warmup the accumulation is 1 (every
# micro-step steps the optimizer); past it, at batch 8, it is 8: the first
# two micro-steps accumulate (DDP's no_sync) and the third applies all three
STARTS = {"every_step": (0, -1_000_000), "accumulate": (1001, 995)}


def rel_close(got, want, rtol, what, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * np.abs(want).max() + floor
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(), tol)


def global_batch(rng, n_img=BATCH, img=IMG):
    """Images with bright plate rectangles; labels on the first half only,
    so that rank 1 of 2 holds no ground truth at all."""
    imgs = rng.integers(0, 80, (n_img, img, img, 3), np.uint8)
    labels = np.zeros((n_img, 3, 20), np.float32)
    labels[..., :8] = -1
    mask = np.zeros((n_img, 3), np.float32)
    for b in range(n_img // 2):
        for i in range(1 + b % 2):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.25, 0.4), rng.uniform(0.12, 0.2)
            x1, y1 = int((cx - w / 2) * img), int((cy - h / 2) * img)
            x2, y2 = int((cx + w / 2) * img), int((cy + h / 2) * img)
            imgs[b, y1:y2, x1:x2] = 220
            labels[b, i, :8] = [rng.integers(0, 31), rng.integers(0, 24),
                                *rng.integers(0, 37, 6)]
            labels[b, i, 8:12] = [cx, cy, w, h]
            labels[b, i, 12:20] = [cx - w / 2, cy - h / 2, cx - w / 2, cy + h / 2,
                                   cx + w / 2, cy + h / 2, cx + w / 2, cy - h / 2]
            mask[b, i] = 1
    return torch.from_numpy(imgs), torch.from_numpy(labels), torch.from_numpy(mask)


def test_synced_bn_equals_one_process_on_the_concatenated_batch(tmp_path):
    rng = np.random.default_rng(0)
    c = 6
    bn = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, c)),
          "bias": torch.from_numpy(rng.standard_normal(c) * 0.1),
          "running_mean": torch.from_numpy(rng.standard_normal(c) * 0.1),
          "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c)),
          "num_batches_tracked": torch.tensor(0)}
    # a mean well away from 0, as conv outputs have
    inp = {"x": torch.from_numpy(rng.standard_normal((8, c, 5, 7)) * 2 + 3),
           "g": torch.from_numpy(rng.standard_normal((8, c, 5, 7))), "bn": bn}
    ranks = run_ranks("bn", inp, tmp_path)
    one = case_bn(inp, 0, 1)
    rel_close(torch.cat([r["y"] for r in ranks]), one["y"], 1e-12, "output")
    rel_close(torch.cat([r["x_grad"] for r in ranks]), one["x_grad"], 1e-12, "input gradient")
    for k in ("w_grad", "b_grad"):  # each rank's share; DDP sums them
        rel_close(sum(r[k] for r in ranks), one[k], 1e-12, k)
    # flax's update: 0.97 * running + 0.03 * the global batch's mean and
    # biased variance
    x = inp["x"].numpy()
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3))
    for r in ranks:
        rel_close(r["running_mean"], 0.97 * bn["running_mean"].numpy() + 0.03 * mean, 1e-12,
                  "running mean")
        rel_close(r["running_var"], 0.97 * bn["running_var"].numpy() + 0.03 * var, 1e-12,
                  "running var")
    rel_close(one["running_var"], ranks[0]["running_var"], 1e-12, "one process's running var")


def test_loss_with_one_rank_without_gt_equals_the_global_batch(tmp_path):
    rng = np.random.default_rng(1)
    a = sum((IMG // s) ** 2 for s in (8, 16, 32))
    cfg = LossConfig(img_size=(IMG, IMG), use_dfl=True, reg_max=16, iou_type="giou")

    def head():
        return [torch.from_numpy(rng.uniform(0.01, 0.99, (4, a, 31))),
                torch.from_numpy(rng.uniform(0.01, 0.99, (4, a, 24))),
                torch.from_numpy(rng.uniform(0.01, 0.99, (4, a, 6, 37))),
                torch.from_numpy(rng.standard_normal((4, a, 68))),
                torch.from_numpy(rng.standard_normal((4, a, 8)))]

    _, labels, mask = global_batch(rng, n_img=4)
    inp = {"preds": head(), "teacher": head(), "labels": labels, "mask": mask, "cfg": cfg}
    ranks = run_ranks("loss", inp, tmp_path)
    one = case_loss(inp, 0, 1)
    assert float(ranks[1]["items"][0]) == 0.0  # rank 1 has no foreground
    rel_close(sum(r["total"] for r in ranks), one["total"], 1e-10, "total")
    rel_close(sum(r["items"] for r in ranks), one["items"], 1e-10, "items")
    rel_close(sum(r["kd"] for r in ranks), one["kd"], 1e-10, "distillation terms")
    for i, name in enumerate(("pro", "alp", "ads", "reg", "cor")):
        rel_close(torch.cat([r["grads"][i] for r in ranks]), one["grads"][i], 1e-10, name)
    # what the test guards: each rank normalizing by its own sums gives
    # another loss
    halves = [compute_loss(HeadTrainOutput(None, *(t[h * 2:(h + 1) * 2] for t in inp["preds"])),
                           labels[h * 2:(h + 1) * 2], mask[h * 2:(h + 1) * 2], cfg)[0]
              for h in range(2)]
    assert abs(float(sum(halves) - one["total"])) > 1e-3 * abs(float(one["total"]))


def jax_first_step(inp, start):
    """The float64 jitted JAX train step on the first global batch from the
    port's TrainState `start`."""
    imgs, labels, mask = inp["batches"][0]
    with jax.enable_x64(True):
        step64 = jax.jit(jts.make_train_step(
            JModel(JConfig.named("yololpn"), dtype=jnp.float64),
            JLossConfig(img_size=(IMG, IMG), iou_type="siou"), JSolverConfig(**SOLVER),
            batch_size=BATCH))
        return jax.device_get(step64(jax_state(start), jnp.asarray(imgs.numpy()),
                                     jnp.asarray(labels.numpy()), jnp.asarray(mask.numpy())))


@pytest.fixture(scope="module")
def train_setup(tmp_path_factory):
    """The ranks' train steps and cached epoch, started first; the
    single-process references and the JAX step run meanwhile."""
    from yololp_tpu_torch.data.datasets import TrainValDataset
    from yololp_tpu_torch.data.device_cache import precompute_items
    from yololp_tpu_torch.data.synthetic import make_synthetic_dataset

    tmp = tmp_path_factory.mktemp("train")
    data = make_synthetic_dataset(str(tmp / "data"), n_train=16, n_val=0, img_size=IMG, seed=3)
    precompute_items(TrainValDataset(data["train"], img_size=IMG, augment=False))  # the memos
    rng = np.random.default_rng(5)
    inp = {"config": "yololpn", "train_dir": data["train"], "img_size": IMG,
           "state_dict": {k: v.double() for k, v in
                          jax_to_state_dict(fast_jax_variables("yololpn", seed=23)).items()},
           "loss_cfg": LossConfig(img_size=(IMG, IMG), iou_type="siou"),
           "solver_cfg": SolverConfig(**SOLVER), "batch_size": BATCH,
           "batches": [global_batch(rng) for _ in range(3)], "starts": list(STARTS.values())}
    ranks = Ranks("train", inp, tmp)
    one = {"runs": run_steps(inp, 0, 1), "cache": cached_epoch(inp, 0, 1)}
    start = tts.init_train_state(train_model(inp))
    jax_out = jax_first_step(inp, start)
    return inp, ranks.results(timeout=150), one, start, jax_out


def assert_states_close(got, want, rtol, what):
    for key in ("params", "stats", "ema", "momentum", "grads"):
        floor = 1e-12 * max(float(w.abs().max()) for w in want[key])
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            rel_close(g, w, rtol, f"{what} {key}[{i}]", floor)


@pytest.mark.parametrize("start", list(STARTS))
def test_three_ddp_steps_equal_one_process_on_the_global_batch(train_setup, start):
    _, ranks, one, _, _ = train_setup
    run = list(STARTS).index(start)
    for s, want in enumerate(one["runs"][run]):
        for r in ranks:
            got = r["runs"][run][s]
            assert got["counts"] == want["counts"]
            rel_close(got["total"], want["total"], 1e-10, f"step {s} total")
            rel_close(got["items"], want["items"], 1e-10, f"step {s} items")
    want_counts = {"every_step": [(1, 1, 0), (2, 2, 1), (3, 3, 2)],
                   "accumulate": [(0, 1002, 995), (0, 1003, 995), (1, 1004, 1003)]}[start]
    assert [st["counts"] for st in one["runs"][run]] == want_counts
    for r in ranks:
        assert_states_close(r["runs"][run][-1], one["runs"][run][-1], 1e-8, start)
    # the replicas stay equal: every rank holds the same state
    assert_states_close(ranks[1]["runs"][run][-1], ranks[0]["runs"][run][-1], 0.0, "rank 1")


def test_one_ddp_step_matches_the_jitted_jax_step(train_setup):
    """Rank 0's state after the first micro-step (every_step run) against
    the float64 jitted JAX train step on the global batch from the same
    state (the JAX step under a mesh computes this function)."""
    _, ranks, _, start, (js, jt, ji) = train_setup
    got = ranks[0]["runs"][0][0]
    np.testing.assert_allclose(float(got["total"]), float(jt), rtol=1e-3)
    np.testing.assert_allclose(got["items"].numpy(), np.asarray(ji, np.float64), rtol=1e-3,
                               atol=1e-7)
    assert got["counts"] == (int(js.ema_updates), int(js.step), int(js.last_opt_step))

    def named(names, tensors):
        return {n: t.detach().float().numpy() for n, t in zip(names, tensors)}

    names, stat_names = start.names, start.stat_names
    before = {"params": named(names + stat_names, start.params + start.batch_stats),
              "momentum": named(names, start.momentum),
              "ema": named(names + stat_names, start.ema_params + start.ema_stats)}
    assert_updates_close(named(names + stat_names, got["params"] + got["stats"]),
                         flat({"params": js.params, "batch_stats": js.batch_stats}),
                         before["params"], "params")
    assert_updates_close(named(names, got["momentum"]), flat(js.momentum), before["momentum"],
                         "momentum")
    assert_updates_close(named(names + stat_names, got["ema"]),
                         flat({"params": js.ema_params, "batch_stats": js.ema_stats}),
                         before["ema"], "ema")


def test_cached_epoch_at_two_ranks_equals_one_process(train_setup):
    """One --cache-device epoch of 2 steps (16 frames, global batch 8): each
    rank gathers its half of every row of the global index matrix."""
    _, ranks, one, _, _ = train_setup
    assert one["cache"]["steps"] == 2 and all(r["cache"]["steps"] == 2 for r in ranks)
    for r in ranks:
        rel_close(r["cache"]["items_sum"], one["cache"]["items_sum"], 1e-10, "epoch loss sums")
        assert_states_close(r["cache"], one["cache"], 1e-8, "cached epoch")
