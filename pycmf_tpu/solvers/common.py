"""Shared solver machinery: static config, traced hyperparams, host loop.

Design stance (SURVEY.md §7): a solver is a pure jitted step
``(X, Y, U, V, Z, hyper) → (U, V, Z)`` driven by a thin host loop that checks
tolerance every ``eval_every`` iterations. The static part of the
configuration (links, constraint flags, update masks, sampling sizes) lives in
a frozen, hashable dataclass so jit caches compilations across fits; numeric
hyperparameters are traced scalars so changing alpha/tol never recompiles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.links import LINEAR, check_link
from ..ops.matmul import matmul
from ..ops.sparse import is_sparse, spmm


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static (hashable) solver configuration.

    Mirrors the reference's constructor surface (SURVEY.md §1 layer map) plus
    this build's extensions (hessian_form, line_search_trials).
    """

    x_link: str = LINEAR
    y_link: str = LINEAR
    U_non_negative: bool = True
    V_non_negative: bool = True
    Z_non_negative: bool = True
    update_U: bool = True
    update_V: bool = True
    update_Z: bool = True
    has_Y: bool = True
    # Newton-specific (SURVEY.md §0 "Newton update")
    hessian_form: str = "gauss"  # 'gauss' | 'full'
    line_search_trials: int = 8
    sg_sample_ratio: float = 1.0

    def __post_init__(self):
        check_link(self.x_link)
        check_link(self.y_link)
        if self.hessian_form not in ("gauss", "full"):
            raise ValueError("hessian_form must be 'gauss' or 'full'")
        if not (0.0 < self.sg_sample_ratio <= 1.0):
            raise ValueError("sg_sample_ratio must be in (0, 1]")


class Hyper(NamedTuple):
    """Traced numeric hyperparameters (a pytree of scalars)."""

    alpha: Any
    l1_ratio: Any
    eps: Any
    hessian_pertubation: Any  # reference's spelling (SURVEY.md §0 note b)


def make_hyper(alpha=0.0, l1_ratio=0.0, eps=1e-10, hessian_pertubation=0.2,
               dtype=jnp.float32) -> Hyper:
    c = lambda v: jnp.asarray(v, dtype=dtype)
    return Hyper(c(alpha), c(l1_ratio), c(eps), c(hessian_pertubation))


class Coupled(NamedTuple):
    """A data matrix plus precomputed fit-time constants.

    Dense matrices carry only ``A`` — XLA contracts transposed operands
    natively via dot_general, no materialization needed. For CSR, the
    transpose and the per-row squared norms (Newton line search) are built
    once on the host at fit time — the sparsity pattern is
    iteration-invariant.
    """

    A: Any
    At: Any = None
    row_sq: Any = None       # (p,) per-row ‖aᵢ‖² of A
    row_sq_t: Any = None     # (q,) per-row norms of Aᵀ
    a_sq: Any = None         # scalar ‖A‖²_F (dense; saves a loss-eval pass)


def coupled_mm(C: Coupled, B: jnp.ndarray,
               transpose: bool = False) -> jnp.ndarray:
    """C.A @ B (or C.Aᵀ @ B) for dense, CSR, or chunked-COO operands."""
    from ..ops.chunked import chunked_spmm, chunked_spmm_t, is_chunked

    if is_chunked(C.A):
        return chunked_spmm_t(C.A, B) if transpose else chunked_spmm(C.A, B)
    if is_sparse(C.A):
        return spmm(C.At if transpose else C.A, B)
    a = C.A.T if transpose else C.A
    return matmul(a, B)


class FitResult(NamedTuple):
    U: Any
    V: Any
    Z: Any
    n_iter: int
    loss_history: List[float]      # loss at init + after each eval point
    loss_iters: List[int]          # iteration number of each history entry
    step_times: List[float]        # host wall-time per jitted block


def make_device_fit_loop(step_fn, loss_core, *, carry_rng: bool,
                         aux_loss=None, aux_init=None):
    """Build a fully device-resident fit: the eval/tol loop runs as a
    lax.while_loop inside ONE jitted computation, so a whole fit costs a
    single dispatch + readback (the host loop pays one host sync per
    eval_every iterations).

    step_fn(X, Y, U, V, Z, hyper[, key]) → (U, V, Z)
    loss_core(state, hyper) → scalar
    Returns fit(X, Y, U, V, Z, hyper, rng, tol, max_iter, eval_every) →
    (U, V, Z, n_iter, hist) with hist[j] = loss after j eval points
    (NaN beyond the stop point). Stopping rule identical to the host loop:
    (L_prev − L)/L_init < tol, checked every eval_every iterations.

    aux_loss/aux_init (optional): step_fn instead returns (U, V, Z, aux)
    and eval-point losses come from aux_loss(state, aux, hyper) — for
    steps that already computed the loss ingredients (e.g. MU's XᵀU/UᵀU),
    making loss/tol checks free of extra data passes. aux_init(U, V, Z)
    supplies a zero-valued aux of the right structure for the loop carry
    (it is always overwritten before first use since eval_every ≥ 1).
    The initial loss L0 still comes from loss_core.
    """
    core = device_fit_core(step_fn, loss_core, carry_rng=carry_rng,
                           aux_loss=aux_loss, aux_init=aux_init)
    return jax.jit(core, static_argnames=("max_iter", "eval_every"))


def device_fit_core(step_fn, loss_core, *, carry_rng: bool,
                    aux_loss=None, aux_init=None):
    """Un-jitted device-fit loop (the body of make_device_fit_loop).

    Exposed separately so the sharded runners can place the ENTIRE loop
    inside shard_map — every device runs it in lockstep, synchronized by
    the psums inside step_fn/loss_core, and the multi-chip fit costs one
    dispatch total."""
    with_aux = aux_loss is not None

    def fit(X, Y, U, V, Z, hyper, rng, tol, max_iter: int, eval_every: int):
        eval_every = max(1, min(eval_every, max_iter))
        n_full = max_iter // eval_every
        rem = max_iter - n_full * eval_every
        n_slots = n_full + (2 if rem else 1)
        # History slots at ≥f32 regardless of the factor dtype: a half-
        # precision buffer (possible only for direct solver callers —
        # the estimator rejects sub-f32 factor dtypes) would quantize
        # every recorded loss to ~3 significant digits while the host
        # loop reports f32 (the stop-rule carry is already f32).
        dtype = (jnp.float32 if jnp.dtype(U.dtype).itemsize < 4
                 else U.dtype)
        L0 = loss_core((X, Y, U, V, Z), hyper)
        hist0 = jnp.full((n_slots,), jnp.nan, dtype).at[0].set(L0)
        aux0 = aux_init(U, V, Z) if with_aux else ()

        def run_steps(U, V, Z, key, aux, n, base):
            def one(i, c):
                U, V, Z, key, aux = c
                args = (X, Y, U, V, Z, hyper)
                if carry_rng:
                    args = args + (jax.random.fold_in(key, base + i),)
                out = step_fn(*args)
                if with_aux:
                    U, V, Z, aux = out
                else:
                    U, V, Z = out
                return U, V, Z, key, aux
            return jax.lax.fori_loop(0, n, one, (U, V, Z, key, aux))

        def eval_loss(U, V, Z, aux):
            if with_aux:
                return aux_loss((X, Y, U, V, Z), aux, hyper)
            return loss_core((X, Y, U, V, Z), hyper)

        def cond(c):
            i, stop = c[0], c[1]
            return jnp.logical_and(jnp.logical_not(stop), i < n_full)

        def body(c):
            i, stop, U, V, Z, key, aux, prev, hist = c
            U, V, Z, key, aux = run_steps(U, V, Z, key, aux, eval_every,
                                          i * eval_every)
            loss = eval_loss(U, V, Z, aux)
            hist = hist.at[i + 1].set(loss)
            stop = jnp.logical_and(L0 > 0, (prev - loss) / L0 < tol)
            return i + 1, stop, U, V, Z, key, aux, loss, hist

        key0 = rng if carry_rng else jax.random.PRNGKey(0)
        i, stop, U, V, Z, key, aux, prev, hist = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(0), jnp.asarray(False), U, V, Z, key0, aux0, L0,
             hist0))

        n_iter = i * eval_every
        if rem:
            def with_rem(args):
                U, V, Z, key, aux, hist = args
                U, V, Z, key, aux = run_steps(U, V, Z, key, aux, rem,
                                              n_full * eval_every)
                loss = eval_loss(U, V, Z, aux)
                return U, V, Z, hist.at[i + 1].set(loss)

            def without_rem(args):
                U, V, Z, key, aux, hist = args
                return U, V, Z, hist

            U, V, Z, hist = jax.lax.cond(
                jnp.logical_not(stop), with_rem, without_rem,
                (U, V, Z, key, aux, hist))
            n_iter = n_iter + jnp.where(stop, 0, rem)
        return U, V, Z, n_iter, hist

    return fit


def finish_device_fit(result, eval_every: int, max_iter: int):
    """Convert a device-fit result into host-side history lists.

    The on-device history buffer is NaN-padded beyond the stopping point, so
    "NaN" alone is ambiguous. The slots actually written are derivable from
    n_iter (init + one per completed eval block + the remainder block if it
    ran); a non-finite value INSIDE that prefix is divergence and raises —
    the device loop cannot raise mid-flight, so this is where the host-loop
    FloatingPointError semantics are restored for loop='device'.
    """
    U, V, Z, n_iter, hist = result
    # Start both small copies before either wait, so the readback costs
    # one device sync instead of two.
    for a in (n_iter, hist):
        if hasattr(a, "copy_to_host_async"):
            a.copy_to_host_async()
    n_iter = int(n_iter)
    hist = np.asarray(jax.device_get(hist), dtype=np.float64)
    eval_every = max(1, min(eval_every, max_iter))
    n_blocks = n_iter // eval_every
    rem_ran = n_iter - n_blocks * eval_every > 0
    n_filled = 1 + n_blocks + (1 if rem_ran else 0)
    written = hist[:n_filled]
    if not np.all(np.isfinite(written)):
        raise FloatingPointError(
            f"non-finite loss during device-resident fit (n_iter={n_iter}, "
            f"history={written.tolist()}); this usually means the problem "
            "scale overflows the compute dtype — try dtype='float32' (or "
            "'float64' on CPU), a larger hessian_pertubation (Newton), or "
            "alpha-regularization. Use loop='host' to locate the failing "
            "iteration.")
    losses = [float(v) for v in written]
    iters = [0] + [min((j + 1) * eval_every, max_iter)
                   for j in range(len(losses) - 1)]
    return U, V, Z, n_iter, losses, iters


def amortize_step_times(wall: float, loss_iters) -> List[float]:
    """Per-eval-block times for the device-resident fit (§5 observability).

    The device loop runs the WHOLE tol-checked fit in one dispatch, so only
    the total wall time is host-observable. Each executed block is the same
    traced work (eval_every iterations + one loss eval; the remainder block
    pro-rated), so the contractual per-block vector is the total amortized
    proportionally to each block's iteration span. Restores
    ``len(step_times_) == len(loss_history_) - 1`` on loop='device';
    entries are amortized shares of one measured dispatch, not individually
    timed blocks (the host loop gives individually timed blocks).
    """
    spans = np.diff(np.asarray(loss_iters, dtype=np.float64))
    total = float(spans.sum())
    if spans.size == 0 or total <= 0:
        return [wall] if spans.size else []
    return [wall * float(s) / total for s in spans]


def run_solver_loop(block_fn, state, hyper, rng, *, max_iter: int, tol: float,
                    eval_every: int, verbose: int = 0,
                    initial_loss_fn=None) -> tuple:
    """Generic host loop: jitted blocks of ``eval_every`` iterations with a
    relative-decrease stopping rule (SURVEY.md §0 "Convergence"):

        stop when (L_prev − L) / L_init < tol
    """
    eval_every = max(1, min(eval_every, max_iter))
    loss_history: List[float] = []
    loss_iters: List[int] = []
    step_times: List[float] = []

    if initial_loss_fn is not None:
        loss_init = float(initial_loss_fn(state, hyper))
        loss_history.append(loss_init)
        loss_iters.append(0)
    else:
        loss_init = None

    prev_loss = loss_init
    n_iter = 0
    while n_iter < max_iter:
        n_steps = min(eval_every, max_iter - n_iter)
        t0 = time.perf_counter()
        state, loss, rng = block_fn(state, hyper, rng, n_steps)
        loss = float(loss)
        step_times.append(time.perf_counter() - t0)
        n_iter += n_steps
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite loss ({loss}) at iteration {n_iter}; this "
                "usually means the problem scale overflows the compute "
                "dtype — try dtype='float32'→'float64' (CPU), a larger "
                "hessian_pertubation (Newton), or alpha-regularization. "
                f"History so far: {loss_history}")
        loss_history.append(loss)
        loss_iters.append(n_iter)
        if verbose:
            print(f"[pycmf_tpu] iter {n_iter:5d}  loss {loss:.8g}")
        if loss_init is None:
            loss_init = loss_history[0]
        if prev_loss is not None and loss_init > 0:
            if (prev_loss - loss) / loss_init < tol:
                break
        prev_loss = loss
    return state, n_iter, loss_history, loss_iters, step_times
