"""The port's timing helpers (yololp_tpu_torch/utils/profiler.py), the
counterparts of tests/test_profiler.py, on the CPU: the value-fetch
reduction, tree-aware operand rolling (the same rolled contents as the JAX
`_fresh_rolled`), the K->2K scaling guard; and the trace, annotate and
model_flops helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.utils.profiler import _fresh_rolled as j_fresh_rolled
from yololp_tpu_torch.utils import profiler as tp

torch.set_num_threads(2)


def _make_matmul_scan(k):
    def run(x0, w):
        x = x0
        for _ in range(k):
            x = torch.tanh(x @ w)
        return x
    return run


def _operands(n):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, n)).astype(np.float32))
    w = torch.from_numpy((np.random.default_rng(1).standard_normal((n, n)) * 0.1).astype(np.float32))
    return x, w


def test_timed_scan_returns_positive_per_iter():
    dt = tp.timed_scan(_make_matmul_scan(4), 4, *_operands(128))
    assert dt > 0
    # the single-call K->2K difference is clamped positive, as in the JAX helper
    assert tp.timed_scan_delta(_make_matmul_scan, 4, *_operands(128)) > 0


def test_delta2_scales_and_guards():
    x, w = _operands(256)
    dt = tp.timed_scan_delta2(_make_matmul_scan, 8, x, w, repeats=2)
    assert dt > 0

    # a make_fn whose cost does not scale with K must trip the guard; the
    # walls of two equal-cost loops differ only by host noise, which can
    # exceed the 5% threshold once under a loaded host, hence 3 attempts
    def constant_cost(k):
        return _make_matmul_scan(8)  # ignores k

    for _ in range(3):
        try:
            tp.timed_scan_delta2(constant_cost, 8, x, w, repeats=3, attempts=1)
        except RuntimeError as e:
            assert "did not scale" in str(e)
            break
    else:
        pytest.fail("K->2K scaling guard never tripped in 3 attempts")


@pytest.mark.parametrize("scaling_from_k, expect", [(8, 0.125), (None, "did not scale")])
def test_delta2_alternates_and_retries_at_twice_k(monkeypatch, scaling_from_k, expect):
    """The K and 2K calls alternate after one warm call of each; a
    measurement that does not scale is taken anew at twice the K, up to 3 in
    all. Walls are scripted by K: flat (1.0) below `scaling_from_k`, then K/8."""
    calls = []

    def make_fn_of_k(k):
        def run(x):
            calls.append(k)
            return x
        return run

    def wall(k):
        return 1.0 if scaling_from_k is None or k <= scaling_from_k else k / 8

    def fake_fetch(fn, op):
        fn(*op)
        return wall(calls[-1])

    monkeypatch.setattr(tp, "_timed_value_fetch", fake_fetch)
    x = torch.zeros(4)
    if isinstance(expect, str):
        with pytest.raises(RuntimeError, match=expect):
            tp.timed_scan_delta2(make_fn_of_k, 4, x, repeats=2)
        assert calls == [4, 8] * 3 + [8, 16] * 3 + [16, 32] * 3
    else:
        # K=4 is flat (1.0 vs 1.0); K=8 scales: (2.0 - 1.0) / 8
        assert tp.timed_scan_delta2(make_fn_of_k, 4, x, repeats=2) == expect
        assert calls == [4, 8] * 3 + [8, 16] * 3


def test_fresh_rolled_changes_contents_not_structure():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    tree = {"a": torch.tensor(3.0), "b": torch.from_numpy(x)}
    scalar = torch.tensor(3.0)
    r_tree, r_scalar = tp._fresh_rolled((tree, scalar), 1)
    assert r_scalar is scalar and r_tree["a"] is tree["a"]
    np.testing.assert_array_equal(r_tree["b"].numpy(), np.roll(x, 1, axis=0))
    # the same contents as the JAX helper on the same tree
    j_tree, _ = j_fresh_rolled(({"a": jnp.float32(3.0), "b": jnp.asarray(x)}, jnp.float32(3.0)), 1)
    np.testing.assert_array_equal(r_tree["b"].numpy(), np.asarray(j_tree["b"]))
    # fresh_operands rolls every tensor of ndim > 0 and copies the rest
    (f_tree, f_scalar) = tp.fresh_operands((tree, scalar))
    np.testing.assert_array_equal(f_tree["b"].numpy(), np.roll(x, 1, axis=0))
    assert float(f_scalar) == 3.0 and f_scalar is not scalar


def test_fresh_rolled_no_arrays_is_identity():
    op = (torch.tensor(1.0), 2)
    assert tp._fresh_rolled(op, 3) is op


def test_trace_annotate_and_model_flops(tmp_path):
    x, w = _operands(32)
    with tp.trace(str(tmp_path)):
        with tp.annotate("matmul_scan"):
            _make_matmul_scan(2)(x, w)
    assert list(tmp_path.glob("*.json")), "no trace written"
    out = tp.model_flops(_make_matmul_scan(3), x, w)
    assert out == {"flops": 3 * 2 * 32 ** 3, "peak_memory_bytes": None}
