"""Multiplicative-update (MU) solver.

Lee–Seung multiplicative updates generalized to the shared factor V
(SURVEY.md §0 "MU update rules", binding):

    U ← U ⊙ (X V)        ⊘ (U (VᵀV)        + l1 + l2·U + ε)
    Z ← Z ⊙ (Yᵀ V)       ⊘ (Z (VᵀV)        + l1 + l2·Z + ε)
    V ← V ⊙ (Xᵀ U + Y Z) ⊘ (V (UᵀU + ZᵀZ) + l1 + l2·V + ε)

with l1 = alpha·l1_ratio, l2 = alpha·(1−l1_ratio) (sklearn-NMF-style
regularized denominators). Update order is pinned to U → Z → V
(SURVEY.md §7 hard part #4: ordering changes trajectories; this is the
assumed reference order until parity goldens say otherwise).

Design: one iteration is six large matmuls plus elementwise ratio updates,
all left to XLA: dense data passes are plain dots, CSR ones gather +
segment-sum, and XLA fuses each per-factor "Gram-matmul + ratio" tail
itself. Linear link only; all factors non-negative (validated by the
estimator, as in the reference).
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp

from ..ops.losses import total_loss
from ..ops.matmul import gram, matmul
from .common import Coupled, Hyper, SolverConfig, coupled_mm, run_solver_loop


def mu_ratio_update(M, S, num, l1, l2, eps):
    """M ⊙ num ⊘ (M S + l1 + l2·M + ε) — the MU tail (S is the k×k Gram)."""
    return M * num / (matmul(M, S) + l1 + l2 * M + eps)


@lru_cache(maxsize=None)
def make_mu_step(cfg: SolverConfig, with_aux: bool = False):
    """Build the pure jitted MU step for a static config.

    with_aux: additionally return (numV_x, gramU) = (XᵀU_new, U_newᵀU_new)
    — V's X-side update terms, which the step computes anyway. The fit
    loops use them to evaluate the loss via the factored identity with
    ZERO extra passes over X (see _aux_loss), so loss/tol checks are free.
    Requires update_U and update_V (both quantities must be fresh).
    """
    if with_aux:
        assert cfg.update_U and cfg.update_V

    def step(X: Coupled, Y, U, V, Z, hyper: Hyper):
        l1 = hyper.alpha * hyper.l1_ratio
        l2 = hyper.alpha * (1.0 - hyper.l1_ratio)
        eps = hyper.eps

        from ..ops.chunked import chunked_mu_u_pass, is_chunked

        # V is unchanged between the U and Z updates (pinned U → Z → V
        # order), so one Gram serves both.
        VtV = gram(V) if (cfg.update_U or (cfg.has_Y and cfg.update_Z)) \
            else None
        num_vx = gram_u = None
        if cfg.update_U:
            with jax.named_scope("mu/update_U"):
                if is_chunked(X.A) and cfg.update_V:
                    # single X pass: the streamed U pass also returns the
                    # X-side of V's numerator and Gram (ops/chunked.py)
                    U, num_vx, gram_u = chunked_mu_u_pass(
                        X.A, U, V, VtV, l1, l2, eps)
                else:
                    num = coupled_mm(X, V)
                    U = mu_ratio_update(U, VtV, num, l1, l2, eps)
        if cfg.has_Y and cfg.update_Z:
            with jax.named_scope("mu/update_Z"):
                num = coupled_mm(Y, V, transpose=True)
                Z = mu_ratio_update(Z, VtV, num, l1, l2, eps)
        if cfg.update_V:
            with jax.named_scope("mu/update_V"):
                if num_vx is None:
                    num_vx = coupled_mm(X, U, transpose=True)
                    gram_u = gram(U)
                num, S = num_vx, gram_u
                if cfg.has_Y:
                    num = num + coupled_mm(Y, Z)
                    S = S + gram(Z)
                V = mu_ratio_update(V, S, num, l1, l2, eps)
        if with_aux:
            return U, V, Z, (num_vx, gram_u)
        return U, V, Z

    return step


@lru_cache(maxsize=None)
def _aux_loss(cfg: SolverConfig):
    """Loss from the step's aux terms — NO pass over X.

    L_x = ½(‖X‖² − 2·Σ(numV_x ⊙ V) + Σ(gramU ⊙ VᵀV)) with numV_x = XᵀU and
    gramU = UᵀU taken from the step just run (U, V are the post-step
    factors: numV_x uses U_new and is contracted against V_new, exactly
    ⟨X, U Vᵀ⟩ at the current iterate). The Y term is evaluated directly
    (Y is the small matrix). Same value as _loss_core up to fp association.
    """
    from ..ops.chunked import is_chunked as _is_ck
    from ..ops.losses import penalty, reconstruction_term
    from ..ops.sparse import is_sparse as _is_sp

    def loss_fn(state, aux, hyper: Hyper):
        X, Y, U, V, Z = state
        num_vx, gram_u = aux
        # CSR and ChunkedCoo both carry their own Σdata² (the canonical
        # source ops/losses.py uses); X.a_sq may be None for direct
        # run_mu callers that build the Coupled by hand
        a_sq = (X.A.sq_norm if _is_sp(X.A) or _is_ck(X.A) else X.a_sq)
        inner = jnp.sum(num_vx * V)
        x_term = 0.5 * (a_sq - 2.0 * inner + jnp.sum(gram_u * gram(V)))
        loss = x_term + penalty(U, hyper.alpha, hyper.l1_ratio) \
            + penalty(V, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = loss + reconstruction_term(Y.A, V, Z, cfg.y_link,
                                              a_sq=Y.a_sq)
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_ok(cfg: SolverConfig, X: Coupled, U0) -> bool:
    """Whether the zero-extra-pass aux loss applies: both U and V updated
    (fresh aux), and not the small-mixed-precision regime where the
    factored identity suffers cancellation (ops/losses.py picks a direct
    streamed residual there — keep the two paths consistent)."""
    from ..ops.chunked import is_chunked as _is_ck
    from ..ops.sparse import is_sparse as _is_sp

    if not (cfg.update_U and cfg.update_V):
        return False
    if _is_ck(X.A) or _is_sp(X.A):
        return True
    return X.a_sq is not None and not (
        X.A.dtype != U0.dtype and X.A.size < (1 << 22))


@lru_cache(maxsize=None)
def _loss_core(cfg: SolverConfig):
    def loss_fn(state, hyper: Hyper):
        X, Y, U, V, Z = state
        YA = Y.A if cfg.has_Y else None
        return total_loss(X.A, YA, U, V, Z, cfg.x_link, cfg.y_link,
                          hyper.alpha, hyper.l1_ratio, x_a_sq=X.a_sq,
                          y_a_sq=(Y.a_sq if cfg.has_Y else None))

    return loss_fn


@lru_cache(maxsize=None)
def _make_loss(cfg: SolverConfig):
    return jax.jit(_loss_core(cfg))


def _aux_zero(U, V, Z):
    k = U.shape[1]
    return (jnp.zeros_like(V), jnp.zeros((k, k), U.dtype))


@lru_cache(maxsize=None)
def _make_block(cfg: SolverConfig, aux: bool = False):
    step = make_mu_step(cfg, with_aux=aux)

    @partial(jax.jit, static_argnames=("n_steps",))
    def block(state, hyper: Hyper, rng, n_steps: int):
        X, Y, U, V, Z = state

        if aux:
            def body(_, c):
                U, V, Z, _aux = c
                return step(X, Y, U, V, Z, hyper)

            U, V, Z, a = jax.lax.fori_loop(
                0, n_steps, body, (U, V, Z, _aux_zero(U, V, Z)))
            loss = _aux_loss(cfg)((X, Y, U, V, Z), a, hyper)
        else:
            def body(_, fac):
                return step(X, Y, *fac, hyper)

            U, V, Z = jax.lax.fori_loop(0, n_steps, body, (U, V, Z))
            loss = _make_loss(cfg)((X, Y, U, V, Z), hyper)
        return (X, Y, U, V, Z), loss, rng

    return block


@lru_cache(maxsize=None)
def _make_device_fit(cfg: SolverConfig, aux: bool = False):
    from .common import make_device_fit_loop

    step = make_mu_step(cfg, with_aux=aux)

    def step_fn(X, Y, U, V, Z, hyper):
        return step(X, Y, U, V, Z, hyper)

    if aux:
        return make_device_fit_loop(step_fn, _loss_core(cfg),
                                    carry_rng=False,
                                    aux_loss=_aux_loss(cfg),
                                    aux_init=_aux_zero)
    return make_device_fit_loop(step_fn, _loss_core(cfg), carry_rng=False)


def run_mu(X: Coupled, Y, U0, V0, Z0, cfg: SolverConfig, hyper: Hyper, *,
           max_iter: int = 200, tol: float = 1e-4, eval_every: int = 10,
           verbose: int = 0, loop: str = "host"):
    """MU solver driver. loop='host' checks tolerance on the host every
    eval_every iterations (one dispatch per block); loop='device' runs the
    whole tol-checked fit as a single on-device lax.while_loop (one dispatch
    per fit)."""
    import time as _time

    from .common import amortize_step_times, finish_device_fit

    aux = _aux_ok(cfg, X, U0)
    if loop == "device":
        fitf = _make_device_fit(cfg, aux)
        tol_s = jnp.asarray(tol, U0.dtype)
        t0 = _time.perf_counter()
        out = fitf(X, Y, U0, V0, Z0, hyper, None, tol_s, max_iter,
                   eval_every)
        U, V, Z, n_iter, losses, iters = finish_device_fit(
            out, eval_every, max_iter)
        return U, V, Z, n_iter, losses, iters, \
            amortize_step_times(_time.perf_counter() - t0, iters)

    block = _make_block(cfg, aux)
    loss_fn = _make_loss(cfg)
    state = (X, Y, U0, V0, Z0)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, state, hyper, rng=None, max_iter=max_iter, tol=tol,
        eval_every=eval_every, verbose=verbose, initial_loss_fn=loss_fn,
    )
    _, _, U, V, Z = state
    return U, V, Z, n_iter, losses, iters, times
