"""Masked per-row backtracking step selection — the ONE implementation
of the pinned accept rule shared by every jnp Newton path.

The rule is a parity contract (PINNED_ASSUMPTIONS.md): candidates are
steps 0.5^t for t = 0..trials-1 evaluated in order, a candidate is
accepted iff its per-row objective φ STRICTLY decreases from φ(M), each
row takes the FIRST (largest) accepted step, and rows with no accepted
candidate keep their current value. trials <= 0 means a plain (projected)
Newton step.

Callers supply φ and the projection so the objective can close over
whatever candidate-independent context it has (factored quad terms, a
dense residual block, streamed chunks, psummed partials).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def backtracking_select(phi, project, M, d, trials: int,
                        return_phi: bool = False):
    """Select per-row updates of M along direction d (shape of M).

    phi(Mc) -> (rows,) per-row objective; project(Mc) -> Mc projected
    (applied BEFORE φ, so the accept test sees the feasible point).
    return_phi: additionally return the per-row objective AT the selected
    value (the accepted candidate's φ, or φ(M) for rows that kept M) — the
    step just evaluated it, so callers can assemble an eval loss with zero
    extra data passes (solvers/newton.py φ-aux); requires trials >= 1 (a
    plain Newton step evaluates no objective)."""
    if trials <= 0:
        assert not return_phi, "return_phi needs trials >= 1"
        return project(M - d)
    steps = 0.5 ** jnp.arange(trials, dtype=M.dtype)
    phi0 = phi(M)

    def trial(_, s):
        Mc = project(M - s * d)
        return None, (Mc, phi(Mc))

    # scan keeps the trace size independent of the trial count (the line
    # search dominates the Newton step's compile cost otherwise)
    _, (cands, phis) = jax.lax.scan(trial, None, steps)
    accepted = phis < phi0[None, :]
    first = jnp.argmax(accepted, axis=0)     # first (largest) accepted
    any_acc = jnp.any(accepted, axis=0)
    chosen = jnp.take_along_axis(cands, first[None, :, None], axis=0)[0]
    out = jnp.where(any_acc[:, None], chosen, M)
    if return_phi:
        sel = jnp.take_along_axis(phis, first[None, :], axis=0)[0]
        return out, jnp.where(any_acc, sel, phi0)
    return out
