"""Sparse matrix support for CMF.

The reference accepts ``scipy.sparse`` CSR inputs for the bag-of-words matrix
(SURVEY.md §2 component 2, BASELINE.json config #3). Here the sparse path is
re-designed for jit instead of porting scipy semantics:

- ``CsrMatrix`` is a *static-shape* pytree holding CSR arrays plus a
  precomputed COO row-id vector (``row_ids``), so that segment-sum SpMM
  works without any dynamic shapes under ``jit``.
- Transposes are precomputed once on the host at ``fit`` time (the sparsity
  pattern is constant across solver iterations), giving us `X @ B` and
  `Xᵀ @ B` as two forward SpMMs — no on-device transposition.
- The squared Frobenius norm of the data is cached so linear-link losses can
  be evaluated via the factored identity without densifying
  (SURVEY.md §3.4: "evaluates the residual without densifying").

Everything here is backend-agnostic jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np



@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Static-shape CSR (+ COO row ids) matrix pytree.

    Fields
    ------
    data     : (nnz,)  float values
    indices  : (nnz,)  int32 column indices
    indptr   : (p+1,)  int32 row pointers
    row_ids  : (nnz,)  int32 row index of each nonzero (COO expansion)
    sq_norm  : ()      sum(data**2), cached for factored losses
    shape    : static (p, q)
    """

    data: jnp.ndarray
    indices: jnp.ndarray
    indptr: jnp.ndarray
    row_ids: jnp.ndarray
    sq_norm: jnp.ndarray
    shape: Tuple[int, int]

    def tree_flatten(self):
        return (
            (self.data, self.indices, self.indptr, self.row_ids, self.sq_norm),
            self.shape,
        )

    @classmethod
    def tree_unflatten(cls, shape, leaves):
        data, indices, indptr, row_ids, sq_norm = leaves
        return cls(data, indices, indptr, row_ids, sq_norm, shape)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CsrMatrix":
        """sq_norm is CAST, never re-accumulated at the target dtype: it
        is a whole-objective constant, and a half-precision sum would
        bias the factored loss (same policy as csr_from_scipy, which
        keeps it f32 under bf16 data)."""
        sq_dt = (jnp.float32 if jnp.dtype(dtype).itemsize < 4
                 else jnp.dtype(dtype))
        return CsrMatrix(
            self.data.astype(dtype), self.indices, self.indptr,
            self.row_ids, self.sq_norm.astype(sq_dt), self.shape,
        )


def is_sparse(A) -> bool:
    return isinstance(A, CsrMatrix)


def csr_from_scipy(A, dtype=jnp.float32) -> CsrMatrix:
    """Build a CsrMatrix from a scipy.sparse matrix (host-side, fit-time)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sum_duplicates()
    data = np.asarray(A.data, dtype=dtype)
    indices = np.asarray(A.indices, dtype=np.int32)
    indptr = np.asarray(A.indptr, dtype=np.int32)
    row_ids = np.repeat(
        np.arange(A.shape[0], dtype=np.int32), np.diff(indptr)
    )
    # sq_norm feeds loss/line-search accumulations — keep it f32 even for
    # bf16-stored data (bf16 would quantize the whole-objective constant).
    sq_dt = jnp.float32 if jnp.dtype(dtype) == jnp.dtype(jnp.bfloat16) \
        else dtype
    return CsrMatrix(
        jnp.asarray(data),
        jnp.asarray(indices),
        jnp.asarray(indptr),
        jnp.asarray(row_ids),
        jnp.asarray(np.sum(data.astype(np.float64) ** 2), dtype=sq_dt),
        tuple(int(s) for s in A.shape),
    )


def csr_from_dense(A: np.ndarray, dtype=jnp.float32) -> CsrMatrix:
    import scipy.sparse as sp

    return csr_from_scipy(sp.csr_matrix(np.asarray(A)), dtype=dtype)


def csr_transpose_host(A, dtype=jnp.float32) -> Tuple[CsrMatrix, CsrMatrix]:
    """Host-side: return (csr(A), csr(Aᵀ)) with matched dtypes."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    return csr_from_scipy(A, dtype), csr_from_scipy(A.T.tocsr(), dtype)


def to_dense(A: CsrMatrix) -> jnp.ndarray:
    """Densify on device (tests / small fallbacks only)."""
    p, q = A.shape
    out = jnp.zeros((p, q), dtype=A.dtype)
    return out.at[A.row_ids, A.indices].add(A.data)


# ---------------------------------------------------------------------------
# SpMM and SDDMM primitives (jnp gather + segment-sum formulation)
# ---------------------------------------------------------------------------

def spmm(A: CsrMatrix, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B for CSR A (p×q) and dense B (q×k) → dense (p×k).

    Gather + segment-sum over nonzeros: static shapes, no densification.
    """
    gathered = B[A.indices] * A.data[:, None]  # (nnz, k)
    return jax.ops.segment_sum(
        gathered, A.row_ids, num_segments=A.shape[0], indices_are_sorted=True
    )


def sddmm_rowdots(A: CsrMatrix, M: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Per-row ⟨a_i, (M Bᵀ)_i⟩ for CSR A (p×q), M (p×k), B (q×k) → (p,).

    Used by factored linear-link losses and Newton line search on sparse data:
    only evaluates the product at nonzero positions.
    """
    e = jnp.sum(M[A.row_ids] * B[A.indices], axis=1)  # (nnz,)
    return jax.ops.segment_sum(
        A.data * e, A.row_ids, num_segments=A.shape[0], indices_are_sorted=True
    )


def sddmm_dot(A: CsrMatrix, M: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """⟨A, M Bᵀ⟩ (scalar) without densifying."""
    e = jnp.sum(M[A.row_ids] * B[A.indices], axis=1)
    return jnp.dot(A.data, e, precision=jax.lax.Precision.HIGHEST)


def row_sq_norms(A: CsrMatrix) -> jnp.ndarray:
    """Per-row ‖a_i‖² → (p,)."""
    return jax.ops.segment_sum(
        A.data * A.data, A.row_ids, num_segments=A.shape[0],
        indices_are_sorted=True,
    )


def masked_row_sq_norms(A: CsrMatrix, col_mask: jnp.ndarray) -> jnp.ndarray:
    """Per-row Σⱼ maskⱼ·aᵢⱼ² → (p,) at the mask's (factor) precision.

    The stochastic-Newton column subsample enters the per-row line-search
    objective as a masked row norm (solvers/newton.py: sampling = masking
    for sums without rescaling); recomputed per iteration, so it squares
    at the factor dtype even when the data is stored bf16."""
    d = A.data.astype(col_mask.dtype)
    return jax.ops.segment_sum(
        d * d * col_mask[A.indices], A.row_ids, num_segments=A.shape[0],
        indices_are_sorted=True,
    )

