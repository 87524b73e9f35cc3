"""Port parity: LP-head distillation (losses/distill.py) against the jitted
JAX `distill_loss`, and its weight schedule.

The student and teacher outputs are the train-mode head outputs of two
narrow yolov6m models (reg_max 16, so the DFL term runs) from seeded
weights, fed to both packages as the same numbers.

Tolerances. In fp32: XLA computes `jnp.power(p, 1/T)` with its own pow on
the CPU, which differs from torch's in the last bit of some values (held
alone to rtol 1e-6, as TAL's power is in tests/test_torch_assigners.py), and
its log differs likewise. At T = 20 every tempered probability is near
1/31, so a KL is the difference of two sums ~3000x its size (measured on
these outputs): fp32 rounding of ~6e-8 in the terms reaches ~2e-4 of the
KL. Both terms are held to rtol 2e-4 in fp32, and to rtol 1e-10 with both
packages in float64 (`jax.enable_x64`), which holds the formula itself. The
schedule is exact against the jitted function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_zoo import narrow, random_jax_variables
from yololp_tpu.losses.distill import distill_loss as jdistill_loss
from yololp_tpu.losses.distill import distill_weight_schedule as jschedule
from yololp_tpu.models.effidehead import HeadTrainOutput as JOut
from yololp_tpu_torch.losses.distill import _temper, distill_loss, distill_weight_schedule
from yololp_tpu_torch.models.yolo import Model
from yololp_tpu_torch.utils.config import Config
from yololp_tpu_torch.utils.convert import jax_to_state_dict, load_state_dict_strict

torch.set_num_threads(2)


def _head_output(seed, x):
    model = Model(narrow(Config.named("yolov6m")))
    model = load_state_dict_strict(model, jax_to_state_dict(random_jax_variables(model, seed)))
    return model.train()(x)


@pytest.fixture(scope="module")
def outputs():
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        return _head_output(1, x), _head_output(2, x)


def _jax_out(o, dtype):
    return JOut(None, *(jnp.asarray(t.numpy(), dtype) for t in (o.pro, o.alp, o.ads, o.reg, o.cor)))


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-4), ("float64", 1e-10)])
@pytest.mark.parametrize("use_dfl", [False, True])
def test_distill_loss_matches_jit(outputs, use_dfl, dtype, rtol):
    student, teacher = (o._replace(**{f: getattr(o, f).to(getattr(torch, dtype))
                                      for f in ("pro", "alp", "ads", "reg", "cor")})
                        for o in outputs)
    assert student.reg.shape[-1] == 4 * 17
    fg = np.random.default_rng(3).uniform(size=student.pro.shape[:2]) < 0.3
    fn = jax.jit(lambda s, t, m: jdistill_loss(s, t, m, temperature=20.0, use_dfl=use_dfl,
                                               reg_max=16))
    with jax.enable_x64(dtype == "float64"):
        want = [float(v) for v in fn(_jax_out(student, dtype), _jax_out(teacher, dtype),
                                     jnp.asarray(fg))]
    got = [float(v) for v in distill_loss(student, teacher, torch.from_numpy(fg),
                                          temperature=20.0, use_dfl=use_dfl, reg_max=16)]
    assert want[0] > 0 and (want[1] > 0) == use_dfl
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_temper_pow_within_an_ulp_or_two(outputs):
    p = outputs[0].ads.numpy()
    want = np.asarray(jax.jit(lambda q: jnp.power(jnp.clip(q, 1e-9, 1.0), 1.0 / 20.0))(p))
    np.testing.assert_allclose(_temper(torch.from_numpy(p), 20.0).numpy(), want, rtol=1e-6)


def test_distill_gradient_flows_to_the_student_only(outputs):
    student, teacher = outputs
    s_pro = student.pro.clone().requires_grad_(True)
    t_pro = teacher.pro.clone().requires_grad_(True)
    cls_kd, _ = distill_loss(student._replace(pro=s_pro), teacher._replace(pro=t_pro),
                             torch.ones(student.pro.shape[:2], dtype=torch.bool))
    cls_kd.backward()
    assert s_pro.grad is not None and s_pro.grad.abs().sum() > 0
    assert t_pro.grad is None


def test_schedule_matches_jit():
    fn = jax.jit(jschedule, static_argnums=1)
    for epochs in (1, 3, 7, 300):
        for e in np.linspace(0.0, epochs, 23, dtype=np.float32).tolist() + [0.37, 1.5]:
            assert distill_weight_schedule(e, epochs) == np.float32(fn(e, epochs)), (e, epochs)
    assert distill_weight_schedule(0, 10) == 1.0 and distill_weight_schedule(10, 10) == 0.0
