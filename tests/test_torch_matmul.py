"""Port parity: the matmul (ops/cuda_matmul.py) against the Pallas matmul of
tools/probe_mxu_int8.py, and the `dots` lowering of the int8 convs against
yololp_tpu.quant.int8_infer.

On the CPU the wrapper runs the kernel's plain version. The JAX probe sets
its module globals (jax, jnp, np, lax, _INTERPRET) only in main(), so the
test loads it by path and sets them itself; its `pallas_matmul` then runs
in Pallas interpret mode.

Tolerances: int8 products, accumulators and conv taps exactly equal. bf16:
|port - JAX| <= 2 K 2**-24 (|a| @ |b|) elementwise: both sum exact fp32
products of bf16 values in fp32, in other orders (the bound the card test,
tests/test_torch_cuda.py, holds the kernel to).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import conftest  # noqa: F401  (forces the JAX cpu backend)
from yololp_tpu.quant import int8_infer as jint8
from yololp_tpu_torch.ops import _build, cuda_conv, cuda_matmul
from yololp_tpu_torch.quant import int8_infer as tint8
from yololp_tpu_torch.tools import probe_mxu_int8 as tprobe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jprobe():
    """tools/probe_mxu_int8.py with the globals its main() would set."""
    spec = importlib.util.spec_from_file_location("probe_mxu_int8_jax",
                                                  ROOT / "tools" / "probe_mxu_int8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.jax, mod.jnp, mod.np, mod.lax, mod._INTERPRET = jax, jnp, np, lax, True
    return mod


def to_t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf16_bound(a32, b32):
    """2 K 2**-24 (|a| @ |b|) of the bf16-rounded fp32 operands, in fp64."""
    return 2 * a32.shape[1] * 2.0 ** -24 * (np.abs(a32).astype(np.float64) @ np.abs(b32))


def test_matmul_matches_pallas_matmul(jprobe):
    rng = np.random.default_rng(0)
    m, k, n = 256, 128, 128
    ai = rng.integers(-128, 128, (m, k)).astype(np.int8)
    bi = rng.integers(-128, 128, (k, n)).astype(np.int8)
    want = np.asarray(jprobe.pallas_matmul(jnp.asarray(ai), jnp.asarray(bi), jnp.int32, 128))
    got = cuda_matmul.matmul(to_t(ai), to_t(bi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 2 ** 16

    af = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    bf = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    want = np.asarray(jprobe.pallas_matmul(af, bf, jnp.float32, 128))
    a32, b32 = np.asarray(af, np.float32), np.asarray(bf, np.float32)
    got = cuda_matmul.matmul(to_t(a32).bfloat16(), to_t(b32).bfloat16())
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy().astype(np.float64) - want)
    assert (diff <= bf16_bound(a32, b32)).all(), diff.max()


@pytest.mark.parametrize("m,k,n", [(1000, 24, 12), (97, 2048, 277), (333, 37, 65), (1, 1, 1)])
def test_matmul_plain_ragged_is_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = cuda_matmul.matmul(to_t(a), to_t(b))
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert got.dtype == torch.int32 and got.shape == (m, n)


def test_matmul_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(8, 4, dtype=torch.int8)
    b = torch.zeros(4, 6, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        cuda_matmul.matmul(a.float(), b.float())
    with pytest.raises(TypeError, match="int8"):
        cuda_matmul.matmul(a, b.bfloat16())
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        cuda_matmul.matmul(a[None], b)
    with pytest.raises(ValueError, match="inner"):
        cuda_matmul.matmul(a, b.t().contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_matmul.matmul(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="cuda"):
        cuda_matmul.matmul_cuda(a, b)
    before = _build.launches("mxu_matmul")
    cuda_matmul.matmul(a, b)
    assert _build.launches("mxu_matmul") == before  # the CPU runs the plain version


@pytest.mark.parametrize("n,s,c,o", [(2, 8, 64, 48), (1, 7, 24, 40)])
def test_conv3x3_as_dots_matches_jax_and_the_conv(n, s, c, o):
    rng = np.random.default_rng(c)
    x = rng.integers(-128, 128, (n, s, s, c)).astype(np.int8)
    w_hwio = rng.integers(-128, 128, (3, 3, c, o)).astype(np.int8)
    want = np.asarray(jint8.conv3x3_as_dots(jnp.asarray(x), jnp.asarray(w_hwio)))
    got = tint8.conv3x3_as_dots(to_t(x), to_t(w_hwio))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    acc = cuda_conv.int8_conv_acc_plain(to_t(x), to_t(w_hwio.transpose(3, 0, 1, 2)))
    np.testing.assert_array_equal(got.numpy(), acc.numpy())
    # the dots route of _int8_conv: 3x3/s1 and 1x1/s1 as matmuls, the rest
    # through the conv, every one equal to the JAX route's accumulator
    w_q = to_t(w_hwio.transpose(3, 0, 1, 2))
    w1 = w_hwio[1:2, 1:2]
    for w_j, w_t, stride in ((w_hwio, w_q, 1), (w1, to_t(w1.transpose(3, 0, 1, 2)), 1),
                             (w_hwio, w_q, 2)):
        kh = w_j.shape[0]
        want = np.asarray(jint8._int8_conv(jnp.asarray(x), jnp.asarray(w_j), (stride, stride),
                                           ((kh // 2, kh // 2),) * 2, conv_impl="dots"))
        np.testing.assert_array_equal(tint8._int8_conv(to_t(x), w_t, stride, kh // 2, "dots").numpy(),
                                      want)


def test_probe_conv9dots_matches_jax(jprobe):
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (2, 8, 8, 32)).astype(np.int8)
    w9 = rng.integers(-127, 128, (9, 32, 32)).astype(np.int8)
    want = np.asarray(jprobe.conv9dots(jnp.asarray(x), jnp.asarray(w9)))
    got = tprobe.conv9dots(to_t(x), to_t(w9))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the probe's chain steps
    y = rng.integers(-2 ** 20, 2 ** 20, (4, 4)).astype(np.int32)
    np.testing.assert_array_equal(tprobe._chain_i(to_t(y)).numpy(),
                                  np.asarray(jprobe._chain_i(jnp.asarray(y))))
    f = (rng.standard_normal((4, 4)) * 100).astype(np.float32)
    np.testing.assert_array_equal(tprobe._chain_f(to_t(f)).float().numpy(),
                                  np.asarray(jprobe._chain_f(jnp.asarray(f)), np.float32))


@pytest.mark.parametrize("tap", range(9))
def test_matmul_nt_plain_on_a_strided_tap_equals_the_tap_matmul(tap):
    """The dots plan's K-major tap view w_q[:, dy, dx, :] of (O, 3, 3, C)
    weights (rows 9C apart) gives the product of the (C, O) tap w9[t]:
    int8 exactly, bf16 within 2 K 2**-24 (|a| @ |b|)."""
    rng = np.random.default_rng(10 + tap)
    c, o, m = 32, 24, 96
    dy, dx = divmod(tap, 3)
    w_hwio = rng.integers(-128, 128, (3, 3, c, o)).astype(np.int8)
    w9 = to_t(w_hwio.reshape(9, c, o))
    w_q = to_t(w_hwio.transpose(3, 0, 1, 2))
    view = w_q[:, dy, dx, :]
    assert view.stride() == (9 * c, 1) and cuda_matmul.rows16_ok(view)
    a = to_t(rng.integers(-128, 128, (m, c)).astype(np.int8))
    got = cuda_matmul.matmul_nt(a, view)
    assert got.dtype == torch.int32
    assert torch.equal(got, cuda_matmul.matmul_plain(a, w9[tap].contiguous()))
    assert torch.equal(cuda_matmul.matmul_nt_plain(a, view), got)

    a32 = rng.standard_normal((m, c)).astype(np.float32)
    w32 = rng.standard_normal((o, 3, 3, c)).astype(np.float32)
    ab, wb = to_t(a32).bfloat16(), to_t(w32).bfloat16()
    got = cuda_matmul.matmul_nt(ab, wb[:, dy, dx, :])
    want = cuda_matmul.matmul_plain(ab, wb[:, dy, dx, :].t().contiguous())
    a_r, b_r = ab.float().numpy(), wb[:, dy, dx, :].float().numpy().T
    diff = np.abs(got.numpy().astype(np.float64) - want.numpy())
    assert got.dtype == torch.float32 and (diff <= bf16_bound(a_r, b_r)).all()


def test_matmul_nt_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(8, 40, dtype=torch.int8)
    w = torch.zeros(6, 3, 3, 40, dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        cuda_matmul.matmul_nt(a, w)
    with pytest.raises(ValueError, match="inner"):
        cuda_matmul.matmul_nt(a, w[:, 0, 0, :8])
    with pytest.raises(TypeError, match="int8"):
        cuda_matmul.matmul_nt(a, w[:, 0, 0, :].bfloat16())
    # on the card, rows must start on 16 bytes: 360-byte rows are refused
    # (checked before the device, so the CPU shows it)
    a48 = torch.zeros(8, 48, dtype=torch.int8)[:, :40]
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_matmul.matmul_nt_cuda(a48, w[:, 1, 1, :])
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_matmul.matmul_nt_cuda(a, torch.zeros(6, 48, dtype=torch.int8)[:, :40])
    with pytest.raises(ValueError, match="cuda"):
        cuda_matmul.matmul_nt_cuda(a48, torch.zeros(6, 48, dtype=torch.int8)[:, :40])
    before = _build.launches("mxu_matmul")
    got = cuda_matmul.matmul_nt(a, w[:, 1, 1, :])  # the CPU takes any strides
    assert _build.launches("mxu_matmul") == before and got.shape == (8, 6)
