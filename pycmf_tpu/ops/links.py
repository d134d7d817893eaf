"""Link functions for CMF residual models.

The reference (smn-ailab/PyCMF; see SURVEY.md §0 — the reference mount is empty,
so citations are to the survey, not to reference file:line) supports two links
per matrix: identity ("linear") and elementwise sigmoid, applied to the factor
product before the squared residual:  ½‖A − f(M Bᵀ)‖²_F.

Each link provides f, f' and f'' (the latter two are needed by the Newton
solver's gradient / full-Hessian weights, SURVEY.md §0 "Newton update").
All functions are jnp-traceable (numerically stable sigmoid via
jax.nn.sigmoid).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

LINEAR = "linear"
SIGMOID = "sigmoid"

VALID_LINKS = (LINEAR, SIGMOID)


def check_link(name: str) -> str:
    if name not in VALID_LINKS:
        raise ValueError(f"link must be one of {VALID_LINKS}, got {name!r}")
    return name


def apply_link(name: str, t: jnp.ndarray) -> jnp.ndarray:
    """f(t)."""
    if name == LINEAR:
        return t
    return jax.nn.sigmoid(t)


def link_and_grad(name: str, t: jnp.ndarray):
    """Return (f(t), f'(t)) without recomputing the expensive part."""
    if name == LINEAR:
        return t, None  # f' == 1; callers special-case None as "ones"
    p = jax.nn.sigmoid(t)
    return p, p * (1.0 - p)


def link_second_deriv(name: str, p: jnp.ndarray) -> jnp.ndarray:
    """f''(t) expressed in terms of p = f(t).

    sigmoid: f'' = p(1-p)(1-2p).  linear: 0.
    """
    if name == LINEAR:
        return jnp.zeros_like(p)
    return p * (1.0 - p) * (1.0 - 2.0 * p)
