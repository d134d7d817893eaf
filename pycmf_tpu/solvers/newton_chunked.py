"""Streamed chunked-COO sigmoid-link Newton (full batch).

Closes the last single-chip scale hole: a sigmoid-linked X too big to
densify on the device previously had NO Newton path at all (the estimator
densifies sigmoid inputs because the update materializes dense sigmoid
predictions — true, but only per ROW CHUNK once the data streams).
Reference scope: the row-wise Newton solver with sigmoid link
(SURVEY.md §0 "Newton update", §2 component 4); this module is its
big-X form — all FLOPs are (R, m)-block matmuls and the dense X never
exists on device.

Two shapes of work, both scanning the same row-chunked layout
(ops/chunked.py):

- **Row-local update** (U, and fold-in transforms): a Newton row update
  needs only that row of X. Per chunk: scatter-densify ONCE, build
  g/H, batched k×k solve, masked backtracking line search — all trials
  reuse the in-scope chunk, so one iteration costs ONE scatter pass
  over X (the scatter is the expected cost; not yet measured on the GPU).
- **Column-side terms** (V's X-term: rows of V see X's columns): the
  per-row (G, H) of V accumulate across chunks (pass 1), and the
  line-search objective φ accumulates per candidate in one more pass —
  newton_update_factor's generic term machinery consumes these via the
  `ChunkedT` marker (ops/chunked.py), so the Y-side term, projection,
  and trial selection stay in one implementation.

Semantics are bit-matched to the dense sigmoid path (same op order per
row); parity is tested at f64 rtol≤1e-9 against sparse_mode='dense'.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.chunked import (ChunkedCoo, _densify_chunk, _pad_rows,
                           valid_rows as _valid_rows)
from ..ops.matmul import matmul


def _sigmoid_parts(Xc, Mc, B, hessian_form: str):
    """Per-chunk P, R⊙f', W at factor precision (the dense path's exact
    formulas, _accumulate_term)."""
    P = jax.nn.sigmoid(matmul(Mc, B.T))
    R = P - Xc.astype(P.dtype)
    fp = P * (1.0 - P)
    W = fp * fp
    if hessian_form == "full":
        W = W + R * (fp * (1.0 - 2.0 * P))
    return R * fp, W


def chunked_sigmoid_row_update(X: ChunkedCoo, M, B, hyper, *,
                               trials: int, non_negative: bool,
                               hessian_form: str, row_mask=None,
                               col_mask=None):
    """Row-local streamed Newton update of M (n, k) against X ≈ σ(M Bᵀ).

    One lax.scan over the chunks; each body densifies its chunk once and
    runs the full dense row-batched update on it (g/H build, batched
    solve via _solve_direction, masked line search) — the dense sigmoid
    path's math verbatim, at chunk granularity. Padding rows come out as
    exact zeros (their singular H may solve to NaN, harmlessly row-local).

    col_mask: optional (m,) 0/1 mask — the stochastic-Newton column
    subsample (solvers/newton.sample_mask: masked sums == the dense
    path's gathered sums), applied to G/H weights and the line-search
    objective exactly as the dense masked sigmoid term applies it.
    """
    from .newton import _solve_direction

    n, _ = X.shape
    k = M.shape[1]
    dtype = M.dtype
    l1 = hyper.alpha * hyper.l1_ratio
    l2 = hyper.alpha * (1.0 - hyper.l1_ratio)
    eye = jnp.eye(k, dtype=dtype)
    H_shared = (l2 + hyper.hessian_pertubation) * eye
    Mp = _pad_rows(M, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)
    vp = _valid_rows(X, dtype, row_mask)
    spd = hessian_form == "gauss"
    from ..ops.linesearch import backtracking_select

    def project(Mc):
        return jnp.maximum(Mc, 0.0) if non_negative else Mc

    def body(carry, inp):
        dv, cv, rv, mc, vc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        Rfp, W = _sigmoid_parts(Xc, mc, B, hessian_form)
        if col_mask is not None:
            Rfp = Rfp * col_mask[None, :]
            W = W * col_mask[None, :]
        G = matmul(Rfp, B) + l1 * jnp.sign(mc) + l2 * mc
        H_rows = jnp.einsum("pq,qk,ql->pkl", W, B, B,
                            precision=jax.lax.Precision.HIGHEST)
        d = _solve_direction(H_shared, H_rows, G, spd=spd)

        def phi(Mc):
            r = Xc.astype(Mc.dtype) - jax.nn.sigmoid(matmul(Mc, B.T))
            if col_mask is not None:
                r = r * col_mask[None, :]
            return (l1 * jnp.sum(jnp.abs(Mc), axis=1)
                    + 0.5 * l2 * jnp.sum(Mc * Mc, axis=1)
                    + 0.5 * jnp.sum(r * r, axis=1))

        m_new = backtracking_select(phi, project, mc, d, trials)
        return carry, jnp.where(vc[:, None] > 0.5, m_new, 0.0)

    _, ys = jax.lax.scan(body, None,
                         (X.data, X.cols, X.rows, Mp, vp))
    return ys.reshape(X.n_pad, k)[:n]


class ChunkedTSigCtx(NamedTuple):
    """Line-search context for a ChunkedT sigmoid term (φ streams the
    chunks per candidate — see newton._phi_term)."""
    ck: ChunkedCoo
    B: jnp.ndarray        # (n, k) — the row-side factor, chunked with X
    distributed: bool
    col_mask: object = None   # optional (n,) shard mask on the q axis


class ChunkedSigRowCtx(NamedTuple):
    """Line-search context for a FORWARD-orientation chunked sigmoid term
    (M's rows are X's rows — e.g. U against a column-sharded X in the
    cols layout; φ streams the chunks per candidate)."""
    ck: ChunkedCoo
    B: jnp.ndarray        # (q, k) — the column-side factor
    mask: object          # optional (q,) column mask (sharded padding)
    distributed: bool


def chunked_sigmoid_rowwise_terms(X: ChunkedCoo, M, B,
                                  hessian_form: str, mask=None):
    """(G (p, k), H_rows (p, k, k)) of M (p, k) for the term
    X ≈ σ(M Bᵀ) with X row-chunked ALONGSIDE M (forward orientation —
    the mirror of chunked_sigmoid_colwise_terms, whose output rows index
    X's columns). Per chunk the dense branch's formulas run verbatim and
    the per-row results stack back to (p, ...).

    mask: optional (q,) column mask — the sharded layouts' zero-padding
    columns pair with nonzero σ(·) = 0.5 predictions and must be masked
    exactly as the dense distributed path masks them. Chunk tail rows
    (beyond p) emit garbage G/H rows; they are sliced off on return.
    """
    p = X.shape[0]
    k = M.shape[1]
    Mp = _pad_rows(M, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)

    def body(carry, inp):
        dv, cv, rv, mc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        Rfp, W = _sigmoid_parts(Xc, mc, B, hessian_form)
        if mask is not None:
            Rfp = Rfp * mask[None, :]
            W = W * mask[None, :]
        G = matmul(Rfp, B)
        H = jnp.einsum("pq,qk,ql->pkl", W, B, B,
                       precision=jax.lax.Precision.HIGHEST)
        return carry, (G, H)

    _, (G, H_rows) = jax.lax.scan(
        body, None, (X.data, X.cols, X.rows, Mp))
    return (G.reshape(X.n_pad, k)[:p],
            H_rows.reshape(X.n_pad, k, k)[:p])


def chunked_sigmoid_rowwise_phi(ctx: ChunkedSigRowCtx, Mc) -> jnp.ndarray:
    """Per-row residual objective ½‖xᵢ − σ(B mᵢ)‖² for a candidate M
    (p, k), streamed over X's row chunks (one pass per candidate)."""
    X = ctx.ck
    p = X.shape[0]
    k = Mc.shape[1]
    Mp = _pad_rows(Mc, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)

    def body(carry, inp):
        dv, cv, rv, mc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        r = Xc.astype(Mc.dtype) - jax.nn.sigmoid(matmul(mc, ctx.B.T))
        if ctx.mask is not None:
            return carry, 0.5 * jnp.sum(r * r * ctx.mask[None, :], axis=1)
        return carry, 0.5 * jnp.sum(r * r, axis=1)

    _, ys = jax.lax.scan(body, None, (X.data, X.cols, X.rows, Mp))
    return ys.reshape(X.n_pad)[:p]


def chunked_sigmoid_colwise_terms(X: ChunkedCoo, M, B,
                                  hessian_form: str, col_mask=None):
    """(G (m, k), H_rows (m, k, k)) of M (m, k) for the term
    Xᵀ ≈ σ(M Bᵀ), accumulated over X's row chunks (X's rows are the
    term's q/columns; B = the row-side factor, chunked alongside X).

    Padding rows are masked out of both accumulators — σ(0) = 0.5 on a
    padding row would otherwise bias every column's gradient. col_mask:
    the sharded layouts' (n,) zero-padding mask on the q axis, folded
    into the same per-chunk row mask."""
    m = X.shape[1]
    k = M.shape[1]
    Bp = _pad_rows(B, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)
    vp = _valid_rows(X, M.dtype, col_mask)

    def body(carry, inp):
        G, H = carry
        dv, cv, rv, bc, vc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        # orientation: predictions σ(bc Mᵀ) are the (R, m) block of
        # σ(B Mᵀ) = (σ(M Bᵀ))ᵀ — the term's D block transposed
        Rfp, W = _sigmoid_parts(Xc, bc, M, hessian_form)
        Rfp = Rfp * vc[:, None]
        W = W * vc[:, None]
        G = G + matmul(Rfp.T, bc)
        H = H + jnp.einsum("rm,rk,rl->mkl", W, bc, bc,
                           precision=jax.lax.Precision.HIGHEST)
        return (G, H), None

    acc0 = (jnp.zeros((m, k), M.dtype), jnp.zeros((m, k, k), M.dtype))
    (G, H_rows), _ = jax.lax.scan(
        body, acc0, (X.data, X.cols, X.rows, Bp, vp))
    return G, H_rows


def chunked_sigmoid_colwise_phi(ctx: ChunkedTSigCtx, Mc) -> jnp.ndarray:
    """Per-row residual objective ½‖(Xᵀ)ⱼ − σ(B mⱼ)‖² for a candidate M
    (m, k), streamed over X's row chunks (one pass per candidate)."""
    X = ctx.ck
    k = Mc.shape[1]
    Bp = _pad_rows(ctx.B, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)
    vp = _valid_rows(X, Mc.dtype, ctx.col_mask)

    def body(acc, inp):
        dv, cv, rv, bc, vc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        r = Xc.astype(Mc.dtype) - jax.nn.sigmoid(matmul(bc, Mc.T))
        return acc + 0.5 * jnp.sum(vc[:, None] * r * r, axis=0), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((X.shape[1],), Mc.dtype),
        (X.data, X.cols, X.rows, Bp, vp))
    return acc
