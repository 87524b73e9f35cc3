"""Port parity: the solver (schedule, accumulation, EMA decay, the SGD
update and the EMA update) against the jitted JAX functions.

The port computes the schedule on the host in the jitted program's fp32
arithmetic (solver/build.py); on the steps below (the warmup end, epoch
edges, past the clamp at `epochs`, the Constant scheduler) the momentum and
the accumulation count are held exactly. XLA's cos and exp are its own
approximations; numpy's fp32 cos and the port's correctly rounded exp can
differ from them by an ulp of their output. So the lr and bias lr are held
to lr0 * 2**-23 (one ulp of a cosine near +-1, carried through
lr0 * (1 - lrf) / 2 <= lr0: up to a few ulps of a small lr) plus one ulp of
the value (the last rounding may then fall the other way), and equal on at
least 90% of the steps; the EMA decay is held to 2**-23 absolute (one
ulp of exp's output near 1, which `1 - exp` keeps), and equal on 99%.

The SGD and EMA updates run on yololpn's whole parameter tree. XLA contracts
`mom * v + d` and the EMA's `d * e + (1 - d) * p` into fused multiply-adds
where the port rounds the product first (`torch._foreach_*`), so the updated
values are held to 2 ulps of fp32 (rtol 2.4e-7) with an absolute floor of 2
ulps at the largest magnitude of the tensor (a cancelling sum loses its own
relative precision, not the operands').
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_train_step import fast_jax_variables
from yololp_tpu.solver import build as jb
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.solver import build as tb
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

ULP2 = 2 * 2.0 ** -23


def steps_of(cfg):
    w = jb.warmup_steps(cfg)
    spe = cfg.steps_per_epoch
    edges = [e * spe + d for e in range(cfg.epochs + 3) for d in (-1, 0, 1)]
    return sorted({s for s in list(range(0, 40)) + [w - 1, w, w + 1] + edges
                   + list(range(w - 50, w + 400, 7)) + [w + 10 * cfg.epochs * spe] if s >= 0})


CFGS = [jb.SolverConfig(lr0=0.02, lrf=0.01, epochs=7, steps_per_epoch=37, warmup_epochs=3.0),
        jb.SolverConfig(lr0=0.02, lrf=0.01, epochs=100, steps_per_epoch=17, warmup_epochs=3.0),
        jb.SolverConfig(lr0=0.01, lrf=0.2, epochs=300, steps_per_epoch=501, warmup_epochs=3.0),
        jb.SolverConfig(lr0=0.02, lrf=0.01, epochs=5, steps_per_epoch=3, warmup_epochs=0.0,
                        lr_scheduler="Constant")]


@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_schedule_and_accumulate_equal_jit(ci):
    jcfg = CFGS[ci]
    tcfg = tb.SolverConfig(**jcfg._asdict())
    steps = np.asarray(steps_of(jcfg), np.int32)
    want = [np.asarray(a) for a in jax.jit(jax.vmap(lambda s: jb.schedule(jcfg, s)))(steps)]
    got = np.asarray([tb.schedule(tcfg, int(s)) for s in steps], np.float32).T
    for k, name in enumerate(("lr_w", "lr_b")):
        bound = jcfg.lr0 * 2.0 ** -23 + np.spacing(want[k])
        assert (np.abs(got[k] - want[k]) <= bound).all(), (name, np.abs(got[k] - want[k]).max())
        assert np.mean(got[k] == want[k]) >= 0.9, name
    np.testing.assert_array_equal(got[2], want[2], err_msg="momentum")
    assert tb.warmup_steps(tcfg) == jb.warmup_steps(jcfg)
    for bs in (2, 7, 16, 32, 48):
        acc = np.asarray(jax.jit(jax.vmap(lambda s: jb.accumulate_steps(jcfg, bs, s)))(steps))
        np.testing.assert_array_equal([tb.accumulate_steps(tcfg, bs, int(s)) for s in steps],
                                      acc.astype(np.int64), err_msg=f"batch {bs}")
    # the clamp: far past `epochs` the lr holds the terminal value
    end = tb.warmup_steps(tcfg) + tcfg.epochs * tcfg.steps_per_epoch
    assert tb.schedule(tcfg, end * 10)[0] == tb.schedule(tcfg, end)[0]


def test_ema_decay_equals_jit_to_an_ulp_of_exp():
    us = np.arange(0, 60000, 3, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(jb.ema_decay))(us))
    got = np.asarray([tb.ema_decay(int(u)) for u in us], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
    assert np.mean(got == want) > 0.99


def _tree_to_params(tree):
    """A flax param tree -> {port parameter name: numpy array}."""
    return {k: v.numpy() for k, v in jax_to_state_dict({"params": tree}).items()}


def assert_close_ulps(got, want, err_msg):
    floor = ULP2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=ULP2, atol=floor, err_msg=err_msg)


def test_sgd_and_ema_update_on_yololpn_equal_jit():
    variables = fast_jax_variables("yololpn", seed=17)
    params = variables["params"]
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    vel = jax.tree_util.tree_map(lambda p: 0.1 * rng.standard_normal(p.shape).astype(np.float32),
                                 params)
    ema = jax.tree_util.tree_map(lambda p: p + 0.01 * rng.standard_normal(p.shape).astype(np.float32),
                                 params)
    labels = jb.label_tree(params)
    cfg = jb.SolverConfig(epochs=7, steps_per_epoch=37)
    step, updates = 50, 11
    # both updates take the port's schedule values (test above holds them)
    tlr = tb.schedule(tb.SolverConfig(**cfg._asdict()), step)
    lr_w, lr_b, mom = (jnp.float32(v) for v in tlr)

    new_p, new_v = jax.jit(lambda p, g, v, lw, lb, m: jb.sgd_apply(
        p, g, v, labels, lw, lb, m, cfg.weight_decay))(params, grads, vel, lr_w, lr_b, mom)
    new_e = jax.jit(lambda e, p: jb.ema_update(e, p, updates))(ema, new_p)

    model = load_state_dict_strict(Model(Config.named("yololpn")), jax_to_state_dict(variables))
    names = [n for n, _ in model.named_parameters()]
    groups = tb.label_groups(model)
    codes = {"w": 0, "bnw": 1, "bias": 2}
    want_groups = {k: int(v.flat[0]) for k, v in _tree_to_params(jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, codes[lab], np.float32), labels, params)).items()}
    assert set(groups) == set(want_groups) == set(names)
    assert all(codes[groups[n]] == want_groups[n] for n in names)

    tp = [p.detach().clone() for p in model.parameters()]
    g = _tree_to_params(grads)
    v = _tree_to_params(vel)
    e = _tree_to_params(ema)
    tg = [torch.from_numpy(g[n]) for n in names]
    tv = [torch.from_numpy(v[n].copy()) for n in names]
    te = [torch.from_numpy(e[n].copy()) for n in names]
    tb.sgd_apply(tp, tg, tv, [groups[n] for n in names], *tlr, cfg.weight_decay)
    tb.ema_update(te, tp, updates)

    for ref, got in ((new_p, tp), (new_v, tv), (new_e, te)):
        want = _tree_to_params(jax.device_get(ref))
        for n, t in zip(names, got):
            assert_close_ulps(t.numpy(), want[n], n)
    # the update did move every parameter
    moved = sum(not np.array_equal(t.numpy(), model.state_dict()[n].numpy())
                for n, t in zip(names, tp))
    assert moved == len(names)
