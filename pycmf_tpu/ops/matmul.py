"""Precision-controlled dense matmul helper.

A float32 dot left at the default precision may run in reduced precision
(TF32 tensor cores on an H100). The CMF solvers' matmuls are thin (rank k)
and memory-bandwidth-bound (SURVEY.md §3.1 hot spots), so running them at
Precision.HIGHEST (true float32) costs little while keeping the loss
trajectory close to the float64 reference (SURVEY.md §7 "hard parts" #1).
A module-level default can be overridden per-call or via set_default_precision.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Low-precision STORAGE dtypes that contract in bf16 (the single shared
# policy — validation, the sharded runners and the estimator import it).
FP8_DTYPES = (jnp.float8_e4m3fn, jnp.float8_e5m2)

_PRECISION = jax.lax.Precision.HIGHEST

_NAMES = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def set_default_precision(p) -> None:
    global _PRECISION
    _PRECISION = _NAMES.get(p, p)


def get_default_precision():
    return _PRECISION


def matmul(a: jnp.ndarray, b: jnp.ndarray, precision=None) -> jnp.ndarray:
    """Dense matmul with mixed-precision support.

    When either operand is bfloat16 (the ``data_dtype`` fast path: the big
    data matrix stays bf16 in device memory to halve bandwidth), both
    operands enter the dot in bf16 and accumulation is forced to float32 —
    the result is always float32, never a bf16 accumulate.
    """
    lows = (jnp.bfloat16,) + FP8_DTYPES
    if a.dtype in lows or b.dtype in lows:
        # Native bf16 dot with f32 accumulation. (HIGHEST would ask for
        # float32 arithmetic on upcast operands, which is not a bf16 dot.)
        # fp8 operands (data_dtype fast path) upcast to bf16 first; XLA
        # may fuse the convert into the dot's operand load.
        return jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                          precision=jax.lax.Precision.DEFAULT,
                          preferred_element_type=jnp.float32)
    return jnp.matmul(a, b, precision=precision or _PRECISION)


def gram(m: jnp.ndarray, precision=None) -> jnp.ndarray:
    """mᵀ m (k×k) — the tiny Gram matrices at the heart of the MU rules."""
    return jnp.matmul(m.T, m, precision=precision or _PRECISION)
