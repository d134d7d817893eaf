"""CMF objective evaluation.

Objective (SURVEY.md §0, binding for parity):

    L(U,V,Z) = ½‖X − f_x(U Vᵀ)‖²_F + ½‖Y − f_y(V Zᵀ)‖²_F + R(U)+R(V)+R(Z)
    R(M)     = alpha · ( l1_ratio·‖M‖₁ + ½(1−l1_ratio)·‖M‖²_F )

Design notes (a redesign, not a port):
- linear-link terms are evaluated via the factored Frobenius identity
  ‖A − M Bᵀ‖² = ‖A‖² − 2⟨A, M Bᵀ⟩ + tr((MᵀM)(BᵀB)); for CSR A the inner
  product is an SDDMM over nonzeros, so the n×m residual is never
  materialized (SURVEY.md §3.4).
- sigmoid-link terms need the elementwise link, so they stream over row
  blocks of the product (static block count under jit) instead of
  materializing p×q when large.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .links import LINEAR
from .matmul import gram, matmul
from .sparse import is_sparse, sddmm_dot

# Above this many elements, sigmoid-link residuals stream over row blocks.
_BLOCK_ELEMS = 1 << 24


def penalty(M: jnp.ndarray, alpha, l1_ratio) -> jnp.ndarray:
    """R(M) — sklearn-NMF-style elastic-net penalty (SURVEY.md §0)."""
    l1 = alpha * l1_ratio
    l2 = alpha * (1.0 - l1_ratio)
    return l1 * jnp.sum(jnp.abs(M)) + 0.5 * l2 * jnp.sum(M * M)


def _linear_term(A, M: jnp.ndarray, B: jnp.ndarray,
                 a_sq=None) -> jnp.ndarray:
    """½‖A − M Bᵀ‖² via the factored identity (A dense, CSR or chunked)."""
    cross = jnp.sum(gram(M) * gram(B))
    from .chunked import chunked_inner, is_chunked

    if is_chunked(A):
        # streaming chunked path: a_sq cached at ingest, inner is one
        # scatter+matmul pass over the chunks (ops/chunked.py)
        return 0.5 * (A.sq_norm.astype(M.dtype)
                      - 2.0 * chunked_inner(A, M, B) + cross)
    if is_sparse(A):
        a_sq = A.sq_norm
        inner = sddmm_dot(A, M, B)
    else:
        if A.dtype != M.dtype and A.size < (1 << 22):
            # Mixed precision (bf16-stored data), small problem: the
            # factored identity suffers cancellation — ‖A‖², ⟨A,MBᵀ⟩ and
            # the cross term are each ≫ the residual near convergence, and
            # with few products the quantization noise doesn't average out.
            # Evaluate the residual directly (one streamed data pass).
            # At large sizes the identity is safe: a_sq is precomputed
            # exactly, the cross term is full-precision, and the bf16
            # inner product's random error averages down as 1/√(n·m).
            return _linear_term_direct(A, M, B)
        if a_sq is None:
            Af = A.astype(M.dtype) if A.dtype != M.dtype else A
            a_sq = jnp.sum(Af * Af)
        inner = jnp.sum(matmul(A, B) * M)
    return 0.5 * (a_sq - 2.0 * inner + cross)


def streamed_inner(A, M: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """⟨A, M Bᵀ⟩ = Σ((A @ B) ⊙ M) at factor precision for dense A.

    Mixed precision (bf16/fp8-stored A, f32 factors) upcasts A in row
    blocks inside a scan so only one block's f32 copy is ever live —
    ``A.astype(f32)`` would transiently hold the whole matrix at 2-4× its
    storage size in device memory (shards sized to fit because of
    data_dtype='bfloat16' could OOM at loss-eval time).
    """
    p, q = A.shape
    if A.dtype == M.dtype or p * q <= _BLOCK_ELEMS:
        Af = A.astype(M.dtype) if A.dtype != M.dtype else A
        return jnp.sum(matmul(Af, B) * M)
    bs = max(1, _BLOCK_ELEMS // q)
    nb = -(-p // bs)
    pad = nb * bs - p
    Ap = jnp.pad(A, ((0, pad), (0, 0)))
    Mp = jnp.pad(M, ((0, pad), (0, 0)))

    def body(carry, inp):
        Ab, Mb = inp
        return carry + jnp.sum(matmul(Ab.astype(Mb.dtype), B) * Mb), None

    total, _ = jax.lax.scan(
        body, jnp.zeros((), M.dtype),
        (Ap.reshape(nb, bs, -1), Mp.reshape(nb, bs, -1)))
    return total


def _linear_term_direct(A, M: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """½‖A − M Bᵀ‖² by direct streamed residual (dense A, any dtype)."""
    p, q = A.shape
    if p * q <= _BLOCK_ELEMS:
        r = A.astype(M.dtype) - matmul(M, B.T)
        return 0.5 * jnp.sum(r * r)
    bs = max(1, _BLOCK_ELEMS // q)
    nb = -(-p // bs)
    pad = nb * bs - p
    Ap = jnp.pad(A, ((0, pad), (0, 0)))
    Mp = jnp.pad(M, ((0, pad), (0, 0)))

    def body(carry, inp):
        Ab, Mb = inp
        r = Ab.astype(Mb.dtype) - matmul(Mb, B.T)
        return carry + 0.5 * jnp.sum(r * r), None

    total, _ = jax.lax.scan(
        body, jnp.zeros((), M.dtype),
        (Ap.reshape(nb, bs, -1), Mp.reshape(nb, bs, -1)))
    return total


def _sigmoid_sq_sum(M: jnp.ndarray, B: jnp.ndarray,
                    row_mask: Optional[jnp.ndarray]) -> jnp.ndarray:
    """Σ_ij σ(M Bᵀ)²_ij, streaming over row blocks when large."""
    p, _ = M.shape
    q = B.shape[0]
    if p * q <= _BLOCK_ELEMS:
        s = jax.nn.sigmoid(matmul(M, B.T))
        if row_mask is not None:
            return jnp.sum(row_mask * jnp.sum(s * s, axis=1))
        return jnp.sum(s * s)

    bs = max(1, _BLOCK_ELEMS // q)
    nb = -(-p // bs)
    pad = nb * bs - p
    Mp = jnp.pad(M, ((0, pad), (0, 0)))
    mask = jnp.pad(
        jnp.ones((p,), M.dtype) if row_mask is None else row_mask,
        (0, pad),
    )

    def body(carry, inp):
        Mb, wb = inp
        s = jax.nn.sigmoid(matmul(Mb, B.T))
        return carry + jnp.sum(wb * jnp.sum(s * s, axis=1)), None

    total, _ = jax.lax.scan(
        body, jnp.zeros((), M.dtype),
        (Mp.reshape(nb, bs, -1), mask.reshape(nb, bs)),
    )
    return total


def _sigmoid_term(A, M: jnp.ndarray, B: jnp.ndarray,
                  row_mask: Optional[jnp.ndarray],
                  col_mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """½‖A − σ(M Bᵀ)‖² (A dense or CSR).

    For CSR A:  ‖A − S‖² = Σ S² + Σ_nnz (a² − 2 a·S)  where S = σ(M Bᵀ);
    only Σ S² needs the dense product, and it streams in blocks.

    col_mask: optional (q,) column weights (the cols layout's shard
    padding columns pair with σ(·) = 0.5 ≠ 0 predictions); chunked and
    dense branches only.
    """
    from .chunked import is_chunked

    if is_chunked(A):
        # streamed chunked-COO A: one scatter+residual pass per chunk,
        # chunk padding rows masked (their σ(0) = 0.5 is not data); an
        # optional sharded row_mask folds into the same per-chunk mask
        from .chunked import _densify_chunk, _pad_rows

        from .chunked import valid_rows

        k = M.shape[1]
        Mp = _pad_rows(M, A.n_pad).reshape(A.n_chunks, A.chunk_rows, k)
        valid = valid_rows(A, M.dtype, row_mask)

        def body(carry, inp):
            dv, cv, rv, mb, vc = inp
            Ac = _densify_chunk(A, dv, cv, rv)
            r = Ac.astype(mb.dtype) - jax.nn.sigmoid(matmul(mb, B.T))
            if col_mask is not None:
                # 0/1 mask: r²·mask² = r²·mask
                r = r * col_mask[None, :]
            return carry + 0.5 * jnp.sum(
                vc * jnp.sum(r * r, axis=1)), None

        total, _ = jax.lax.scan(
            body, jnp.zeros((), M.dtype),
            (A.data, A.cols, A.rows, Mp, valid))
        return total
    if col_mask is not None:
        raise NotImplementedError(
            "col_mask is supported for chunked A only (the dense/CSR "
            "sharded paths mask on their own)")
    if is_sparse(A):
        s_sq = _sigmoid_sq_sum(M, B, row_mask)
        e = jnp.sum(M[A.row_ids] * B[A.indices], axis=1)
        s_at_nnz = jax.nn.sigmoid(e)
        if row_mask is not None:
            w = row_mask[A.row_ids]
            nnz_part = jnp.sum(w * (A.data * A.data - 2.0 * A.data * s_at_nnz))
        else:
            nnz_part = A.sq_norm - 2.0 * jnp.dot(
                A.data, s_at_nnz, precision=jax.lax.Precision.HIGHEST)
        return 0.5 * (s_sq + nnz_part)

    p, q = A.shape
    if p * q <= _BLOCK_ELEMS:
        r = A.astype(M.dtype) - jax.nn.sigmoid(matmul(M, B.T))
        if row_mask is not None:
            return 0.5 * jnp.sum(row_mask * jnp.sum(r * r, axis=1))
        return 0.5 * jnp.sum(r * r)

    bs = max(1, _BLOCK_ELEMS // q)
    nb = -(-p // bs)
    pad = nb * bs - p
    Ap = jnp.pad(A, ((0, pad), (0, 0)))
    Mp = jnp.pad(M, ((0, pad), (0, 0)))
    mask = jnp.pad(
        jnp.ones((p,), M.dtype) if row_mask is None else row_mask,
        (0, pad),
    )

    def body(carry, inp):
        Ab, Mb, wb = inp
        r = Ab.astype(Mb.dtype) - jax.nn.sigmoid(matmul(Mb, B.T))
        return carry + 0.5 * jnp.sum(wb * jnp.sum(r * r, axis=1)), None

    total, _ = jax.lax.scan(
        body, jnp.zeros((), M.dtype),
        (Ap.reshape(nb, bs, -1), Mp.reshape(nb, bs, -1), mask.reshape(nb, bs)),
    )
    return total


def reconstruction_term(A, M: jnp.ndarray, B: jnp.ndarray, link: str,
                        row_mask: Optional[jnp.ndarray] = None,
                        a_sq=None) -> jnp.ndarray:
    """½‖A − f(M Bᵀ)‖²_F for one coupled matrix.

    row_mask (optional, dense/sigmoid paths): per-row weights, used by the
    sharded runner to zero out padding rows (linear terms with zero-padded
    A and M contribute exactly 0 and need no mask).
    """
    if link == LINEAR:
        return _linear_term(A, M, B, a_sq)
    return _sigmoid_term(A, M, B, row_mask)


def total_loss(X, Y, U, V, Z, x_link: str, y_link: str, alpha, l1_ratio,
               x_row_mask: Optional[jnp.ndarray] = None, x_a_sq=None,
               y_a_sq=None) -> jnp.ndarray:
    """Full CMF objective L(U, V, Z). Y may be None (single-matrix / NMF)."""
    loss = reconstruction_term(X, U, V, x_link, x_row_mask, x_a_sq)
    loss = loss + penalty(U, alpha, l1_ratio) + penalty(V, alpha, l1_ratio)
    if Y is not None:
        loss = loss + reconstruction_term(Y, V, Z, y_link, a_sq=y_a_sq)
        loss = loss + penalty(Z, alpha, l1_ratio)
    return loss


def reconstruction_rmse(A, M, B, link: str) -> jnp.ndarray:
    """RMSE of A − f(M Bᵀ) over all p·q entries (benchmark parity metric)."""
    p, q = A.shape
    sq = 2.0 * reconstruction_term(A, M, B, link)
    return jnp.sqrt(sq / (p * q))
