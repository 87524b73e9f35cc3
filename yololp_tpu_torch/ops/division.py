"""Division by a constant, as the jitted JAX package computes it.

Inside `jax.jit`, XLA rewrites `x / c` for a constant `c` as `x * (1 / c)`,
the reciprocal rounded once in fp32 (a bf16 `x` is widened to fp32, multiplied
and rounded back). Eager PyTorch divides: on the CPU that is a true division,
which differs from the reciprocal multiply in the last bit (for `u8 / 255.0`
on 126 of the 256 values); on CUDA a division by a Python scalar happens to be
a reciprocal multiply. Wherever the JAX package divides by a trace-time
constant under jit, the port calls `div_const`, which computes the same thing
on the CPU and on the card. Where the divisor is a traced value (a tensor in
the port) or the JAX package computes eagerly, the port keeps the true
division.
"""

from __future__ import annotations

import torch


def reciprocal(c) -> float:
    """fp32(1 / fp32(c)), computed on the host: the constant XLA folds."""
    return float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(c), dtype=torch.float32))


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """`x / c` for a constant `c` as jax.jit computes it: x * fp32(1/c) in
    fp32, rounded back to a narrower float dtype of `x` (a float64 `x`, as in
    a float64 reference run, is multiplied by the double reciprocal)."""
    if x.dtype == torch.float64:
        return x * (1.0 / float(c))
    r = reciprocal(c)
    if x.dtype == torch.float32:
        return x * r
    return (x.float() * r).to(x.dtype)


def unit_pixels(images_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 pixels -> [0, 1] in `dtype`: the JAX package's jitted
    `images.astype(dtype) / jnp.asarray(255.0, dtype)`."""
    return div_const(images_u8.to(dtype), 255.0)
