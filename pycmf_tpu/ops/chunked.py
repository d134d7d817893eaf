"""Streaming chunked-densify sparse path — single-chip X beyond the
densify threshold.

Without it, scattered sparsity too big to densify on one device has only
segment-sum CSR: a per-nonzero gather + segment-sum path whose traffic is
O(nnz·k). This module streams it instead:

- At fit time the COO nonzeros are sorted by row and split into C chunks
  of R rows each (R chosen so the R×m dense buffer is ~256 MB), padded to
  a common per-chunk nnz L with (row 0, col 0, value 0) entries — a
  scatter-ADD of zero is an exact no-op, so padding needs no masking.
- Each solver iteration runs ONE `lax.scan` over the chunks: scatter the
  chunk's nonzeros into a zeroed (R, m) buffer (O(nnz) scalar scatters —
  not the O(nnz·k) gather+segment traffic of segment-sum SpMM), then do
  the dense matmuls on the materialized chunk. The buffer is reused by
  XLA across scan steps, so peak device memory is the COO arrays (~10 bytes/nnz)
  plus ONE chunk — X's dense equivalent never exists on the device.
- For MU, `chunked_mu_u_pass` streams X once per iteration and emits
  U_new plus V's X-side numerator/Gram (the aux contract of
  solvers/mu.py), so the loss/tol check costs no extra pass.

This is the streamed form of the reference's scipy-CSR path
(SURVEY.md §2 component 3 "handles sparse X via spmm in the numerator"):
same math, but the irregular work is one scatter per nonzero and ALL
FLOPs are dense matmuls.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matmul import matmul

# Target size for the reusable dense chunk buffer. 256 MB keeps the
# scatter/compute pipeline deep (many chunks) while each chunk's matmuls
# stay large at CMF ranks.
DEFAULT_BUFFER_BYTES = 256 << 20


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ChunkedCoo:
    """Row-chunked COO matrix (static shapes).

    data    : (C, L) values (storage dtype; bf16 halves memory traffic)
    cols    : (C, L) int32 column indices
    rows    : (C, L) int32 row index WITHIN the chunk (0..R-1)
    sq_norm : ()     Σ data² (float32 — feeds loss accumulations)
    shape   : static logical (n, m)
    chunk_rows : static R — rows per chunk; C·R ≥ n
    """

    data: jnp.ndarray
    cols: jnp.ndarray
    rows: jnp.ndarray
    sq_norm: jnp.ndarray
    shape: Tuple[int, int]
    chunk_rows: int
    true_nnz: int = -1   # actual nonzero count (static; -1 = unknown)

    def tree_flatten(self):
        return ((self.data, self.cols, self.rows, self.sq_norm),
                (self.shape, self.chunk_rows, self.true_nnz))

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        data, cols, rows, sq_norm = leaves
        return cls(data, cols, rows, sq_norm, *aux)

    @property
    def n_chunks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        """True nonzero count (parity with CsrMatrix.nnz)."""
        return self.true_nnz if self.true_nnz >= 0 else self.capacity

    @property
    def capacity(self) -> int:
        """Stored entries INCLUDING the per-chunk padding (C·L)."""
        return int(self.data.shape[0] * self.data.shape[1])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def n_pad(self) -> int:
        return self.n_chunks * self.chunk_rows


def is_chunked(A) -> bool:
    return isinstance(A, ChunkedCoo)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ChunkedT:
    """Marks a chunked layout consumed as its TRANSPOSE: a Newton term
    whose D is conceptually X.ckᵀ (rows of the factor see X's columns).
    No transposed payload exists — consumers stream the forward chunks
    (solvers/newton_chunked.py)."""

    ck: ChunkedCoo

    def tree_flatten(self):
        return (self.ck,), ()

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(leaves[0])


def pick_chunk_rows(n: int, m: int,
                    buffer_bytes: int = DEFAULT_BUFFER_BYTES,
                    itemsize: int = 4) -> int:
    """Rows per chunk: the largest multiple of 128 (a matmul tile) whose
    (R, m) buffer at the storage dtype (``itemsize`` bytes/elt) fits
    ``buffer_bytes``; floor 8 rows."""
    r = buffer_bytes // max(1, m * itemsize)
    if r >= 128:
        r = (r // 128) * 128
        n_up = -(-n // 128) * 128   # cap at n rounded UP (keeps tiling)
    else:
        r = max(8, (r // 8) * 8)
        n_up = -(-n // 8) * 8
    return int(min(r, n_up))


def chunked_from_scipy(A, dtype=jnp.float32, *,
                       chunk_rows: int | None = None,
                       buffer_bytes: int = DEFAULT_BUFFER_BYTES,
                       return_numpy: bool = False) -> ChunkedCoo:
    """Build a ChunkedCoo from a scipy.sparse matrix (host, once per fit).

    Device upload is the COO triplets only (~10 bytes/nnz) — the dense
    form is never copied to the device nor exists there.

    return_numpy: keep the arrays on the host — for callers that
    post-process the layout (the sharded runner stacks per-shard layouts)
    before uploading ONCE.
    """
    import scipy.sparse as sp

    A = sp.coo_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    R = chunk_rows if chunk_rows is not None else pick_chunk_rows(
        n, m, buffer_bytes, jnp.dtype(dtype).itemsize)
    C = -(-n // R)
    order = np.argsort(A.row, kind="stable")
    rows = A.row[order].astype(np.int64)
    cols = A.col[order].astype(np.int32)
    vals = A.data[order]
    counts = np.bincount(rows // R, minlength=C)
    L = max(1, int(counts.max()))
    nnz = int(vals.size)
    if nnz and C * L > 4 * nnz:
        import warnings

        warnings.warn(
            f"chunked-COO padding is {C * L / nnz:.1f}x the true nnz "
            f"({nnz} nonzeros, {C} chunks padded to {L} each): the row "
            "distribution is heavily skewed, and storage AND per-"
            "iteration work scale with the padded count. Consider "
            "shuffling the rows or a different chunk_rows.",
            UserWarning, stacklevel=2)
    d = np.zeros((C, L), dtype=np.float64)
    cc = np.zeros((C, L), dtype=np.int32)
    rl = np.zeros((C, L), dtype=np.int32)
    start = np.zeros(C + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    for i in range(C):
        s, e = start[i], start[i + 1]
        d[i, : e - s] = vals[s:e]
        cc[i, : e - s] = cols[s:e]
        rl[i, : e - s] = (rows[s:e] - i * R).astype(np.int32)
        # padding entries: (row 0, col 0, value 0) — scatter-ADD no-ops
    sq_dt = jnp.float32 if jnp.dtype(dtype).itemsize <= 4 else dtype
    sq64 = np.sum(vals.astype(np.float64) ** 2)
    if return_numpy:
        return ChunkedCoo(d.astype(jnp.dtype(dtype)), cc, rl,
                          np.asarray(sq64, dtype=jnp.dtype(sq_dt)),
                          (n, m), R, nnz)
    return ChunkedCoo(
        jnp.asarray(d, dtype=dtype),
        jnp.asarray(cc),
        jnp.asarray(rl),
        jnp.asarray(sq64, dtype=sq_dt),
        (n, m), R, nnz)


def _pad_rows(M: jnp.ndarray, n_pad: int) -> jnp.ndarray:
    n = M.shape[0]
    return M if n == n_pad else jnp.pad(M, ((0, n_pad - n), (0, 0)))


def valid_rows(X: ChunkedCoo, dtype, row_mask=None) -> jnp.ndarray:
    """(C, R) 1.0 on true rows (the last chunk's tail rows are padding;
    consumers whose per-row results are not exactly zero there — e.g.
    σ(0) = 0.5 — must mask them out of updates and sums).

    row_mask: optional (n,) shard mask (the sharded layouts' zero-padding
    rows sit BELOW this layout's n) — combined multiplicatively."""
    n = X.shape[0]
    valid = (jnp.arange(X.n_pad) < n).astype(dtype)
    if row_mask is not None:
        valid = valid * _pad_rows(
            row_mask[:, None].astype(dtype), X.n_pad)[:, 0]
    return valid.reshape(X.n_chunks, X.chunk_rows)


def _densify_chunk(X: ChunkedCoo, dv, cv, rv) -> jnp.ndarray:
    """Scatter one chunk's nonzeros into a zeroed (R, m) buffer.

    scatter-add at STORAGE dtype: positions are unique (canonical COO), and
    the padding zeros land on (0, 0) harmlessly. The dense chunk then rides
    the normal mixed-precision matmul path (bf16 inputs, f32 accumulate)."""
    R, m = X.chunk_rows, X.shape[1]
    return jnp.zeros((R, m), X.data.dtype).at[rv, cv].add(dv)


def chunked_spmm(X: ChunkedCoo, B: jnp.ndarray) -> jnp.ndarray:
    """X @ B → (n, k): one streamed pass, a dense matmul per chunk."""

    def body(_, inp):
        dv, cv, rv = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        return None, matmul(Xc, B)

    _, ys = jax.lax.scan(body, None, (X.data, X.cols, X.rows))
    out = ys.reshape(X.n_pad, -1)
    return out[: X.shape[0]]


def chunked_spmm_t(X: ChunkedCoo, M: jnp.ndarray) -> jnp.ndarray:
    """Xᵀ @ M → (m, k): streamed accumulation over row chunks."""
    k = M.shape[1]
    Mp = _pad_rows(M, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)

    def body(acc, inp):
        dv, cv, rv, mc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        return acc + matmul(Xc.T, mc), None

    acc0 = jnp.zeros((X.shape[1], k), M.dtype)
    acc, _ = jax.lax.scan(body, acc0, (X.data, X.cols, X.rows, Mp))
    return acc


def chunked_masked_row_sq(X: ChunkedCoo, col_mask: jnp.ndarray
                          ) -> jnp.ndarray:
    """Per-row Σⱼ maskⱼ·xᵢⱼ² → (n,) — the stochastic-Newton column
    subsample's row norms (sampling = masking for unrescaled sums),
    accumulated per nonzero (no chunk densify needed; the padding
    entries' value 0 lands on row 0 harmlessly). Squares at the mask's
    (factor) precision — bf16-stored data does not quantize the norm."""

    def body(_, inp):
        dv, cv, rv = inp
        d = dv.astype(col_mask.dtype)
        seg = jnp.zeros((X.chunk_rows,), col_mask.dtype)
        return None, seg.at[rv].add(d * d * col_mask[cv])

    _, ys = jax.lax.scan(body, None, (X.data, X.cols, X.rows))
    return ys.reshape(X.n_pad)[: X.shape[0]]


def chunked_masked_col_sq(X: ChunkedCoo, row_mask: jnp.ndarray
                          ) -> jnp.ndarray:
    """Per-column Σᵢ maskᵢ·xᵢⱼ² → (m,) for a (n,) row mask — the V-side
    stochastic-Newton subsample (the term's q axis is X's ROW axis).
    Padding tail rows hold no nonzeros, so only the given mask matters."""
    n, m = X.shape
    rm = row_mask.astype(row_mask.dtype)
    rm = jnp.pad(rm, (0, X.n_pad - n)) if n != X.n_pad else rm
    rm = rm.reshape(X.n_chunks, X.chunk_rows)

    def body(acc, inp):
        dv, cv, rv, rmc = inp
        d = dv.astype(row_mask.dtype)
        return acc.at[cv].add(d * d * rmc[rv]), None

    acc, _ = jax.lax.scan(body, jnp.zeros((m,), row_mask.dtype),
                          (X.data, X.cols, X.rows, rm))
    return acc


def chunked_inner(X: ChunkedCoo, M: jnp.ndarray, B: jnp.ndarray):
    """⟨X, M Bᵀ⟩ = Σ((X @ B) ⊙ M) — streamed, scalar out."""
    k = B.shape[1]
    Mp = _pad_rows(M, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)

    def body(acc, inp):
        dv, cv, rv, mc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        return acc + jnp.sum(matmul(Xc, B) * mc), None

    acc, _ = jax.lax.scan(body, jnp.zeros((), M.dtype),
                          (X.data, X.cols, X.rows, Mp))
    return acc


def stack_chunked_blocks(blocks, dtype, *,
                         buffer_bytes: int = DEFAULT_BUFFER_BYTES
                         ) -> ChunkedCoo:
    """Per-shard ChunkedCoo layouts stacked on a leading device dim
    (shard_map operand; the sharded runner's `_local_chunked` drops it).

    All blocks must share .shape (the LOCAL shape). Every shard gets the
    SAME static (chunk_rows, n_chunks, L): chunk geometry is part of the
    traced program, which must be identical across devices.
    """
    local_shape = blocks[0].shape
    R = pick_chunk_rows(local_shape[0], local_shape[1], buffer_bytes,
                        jnp.dtype(dtype).itemsize)
    # return_numpy: stack on the host and upload ONCE — per-shard uploads
    # and device-side stacking would copy the COO arrays three times
    cks = [chunked_from_scipy(b, dtype=dtype, chunk_rows=R,
                              return_numpy=True)
           for b in blocks]
    C = max(x.n_chunks for x in cks)
    L = max(x.data.shape[1] for x in cks)
    d, cc, rl, sq = [], [], [], []
    for x in cks:
        padC = C - x.n_chunks
        padL = L - x.data.shape[1]
        d.append(np.pad(x.data, ((0, padC), (0, padL))))
        cc.append(np.pad(x.cols, ((0, padC), (0, padL))))
        rl.append(np.pad(x.rows, ((0, padC), (0, padL))))
        sq.append(x.sq_norm)
    return ChunkedCoo(
        jnp.asarray(np.stack(d), dtype=dtype),
        jnp.asarray(np.stack(cc)),
        jnp.asarray(np.stack(rl)),
        jnp.asarray(np.stack(sq)),
        local_shape, R, sum(x.true_nnz for x in cks))


def local_chunked(stk: ChunkedCoo) -> ChunkedCoo:
    """Inside shard_map: drop the (length-1) leading device dim."""
    return ChunkedCoo(stk.data[0], stk.cols[0], stk.rows[0],
                      stk.sq_norm[0], stk.shape, stk.chunk_rows,
                      stk.true_nnz)


def stack_chunked_grid(cells, dtype, *,
                       buffer_bytes: int = DEFAULT_BUFFER_BYTES
                       ) -> ChunkedCoo:
    """r×c grid of scipy cells → one ChunkedCoo with (r, c) leading dims
    (shard_map operand under P(ROW, COL); parallel/grid._local_chunked_cell
    drops them).

    All cells share the LOCAL shape, so every cell gets the SAME static
    chunk geometry (R, C); the per-chunk capacity L pads to the global max
    — chunk geometry is part of the traced program, which must be
    identical across mesh positions.

    One implementation serves both meshes: the cells flatten row-major
    through stack_chunked_blocks and the leading device dim reshapes to
    (r, c) — a free device-side view.
    """
    r, c = len(cells), len(cells[0])
    flat = stack_chunked_blocks([b for row in cells for b in row], dtype,
                                buffer_bytes=buffer_bytes)
    leaves, aux = flat.tree_flatten()
    return ChunkedCoo(*(x.reshape((r, c) + x.shape[1:]) for x in leaves),
                      *aux)


def chunked_newton_linear_u_pass(X: ChunkedCoo, U, V, BtB, Hinv, row_sq,
                                 l1, l2, *, trials: int,
                                 non_negative: bool):
    """One streamed Newton U leg (linear link, full batch, Gauss-Newton):
    semantics bit-matched to solvers/newton.newton_update_factor —
    shared H = BtB + (l2+pert)·I (Hinv precomputed by the caller), per-row
    backtracking line search on φ, projection before φ — while streaming
    X once and accumulating V's X-side (XᵀU_new, U_newᵀU_new) for the V
    update and the zero-extra-pass loss.

    row_sq: (n,) per-row ‖xᵢ‖² (fit-time constant, as_coupled).
    Returns (U_new[:n], numV, gramU).
    """
    n, m = X.shape
    k = U.shape[1]
    Up = _pad_rows(U, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)
    rs = jnp.pad(row_sq, (0, X.n_pad - n)) if row_sq.shape[0] != X.n_pad \
        else row_sq
    rs = rs.reshape(X.n_chunks, X.chunk_rows)
    from .linesearch import backtracking_select

    def project(Mc):
        return jnp.maximum(Mc, 0.0) if non_negative else Mc

    def body(carry, inp):
        numV, gramU = carry
        dv, cv, rv, uc, rsc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        DB = matmul(Xc, V)
        G = matmul(uc, BtB) - DB + l1 * jnp.sign(uc) + l2 * uc
        d = matmul(G, Hinv)          # Hinv symmetric: (H⁻¹ Gᵀ)ᵀ = G H⁻¹

        def phi(Mc):
            quad = jnp.sum(matmul(Mc, BtB) * Mc, axis=1)
            res = 0.5 * (rsc - 2.0 * jnp.sum(DB * Mc, axis=1) + quad)
            return res + l1 * jnp.sum(jnp.abs(Mc), axis=1) \
                + 0.5 * l2 * jnp.sum(Mc * Mc, axis=1)

        u_new = backtracking_select(phi, project, uc, d, trials)
        numV = numV + matmul(Xc.T, u_new)
        gramU = gramU + matmul(u_new.T, u_new)
        return (numV, gramU), u_new

    acc0 = (jnp.zeros((m, k), U.dtype), jnp.zeros((k, k), U.dtype))
    (numV, gramU), ys = jax.lax.scan(
        body, acc0, (X.data, X.cols, X.rows, Up, rs))
    return ys.reshape(X.n_pad, k)[:n], numV, gramU


def chunked_mu_u_pass(X: ChunkedCoo, U, V, VtV, l1, l2, eps,
                      row_mask=None):
    """One streamed MU iteration leg: update U and accumulate V's X-side
    terms in the SAME pass over X (solvers/mu.py make_mu_step):

        U_c   ← U_c ⊙ (X_c V) ⊘ (U_c VᵀV + l1 + l2·U_c + ε)   per chunk
        numV  = Σ_c X_cᵀ U_c_new          (XᵀU_new, already global)
        gramU = Σ_c U_c_newᵀ U_c_new      (U_newᵀU_new)

    Returns (U_new[:n], numV, gramU). Padding rows are masked to exact
    zeros in-pass — the ratio alone would give 0/0 = NaN when
    l1 = ε = 0. row_mask (n,) — 1.0 on true rows — lets a sharded caller
    mask its OWN zero-padding rows, which are below this layout's n.
    """
    n, m = X.shape
    k = U.shape[1]
    Up = _pad_rows(U, X.n_pad).reshape(X.n_chunks, X.chunk_rows, k)
    if row_mask is None:
        valid = jnp.arange(X.n_pad) < n
    else:
        valid = _pad_rows(row_mask[:, None].astype(U.dtype),
                          X.n_pad)[:, 0] > 0.5
    vp = valid.reshape(X.n_chunks, X.chunk_rows)

    def body(carry, inp):
        numV, gramU = carry
        dv, cv, rv, uc, vc = inp
        Xc = _densify_chunk(X, dv, cv, rv)
        num = matmul(Xc, V)
        u_new = uc * num / (matmul(uc, VtV) + l1 + l2 * uc + eps)
        u_new = jnp.where(vc[:, None], u_new, 0.0)
        numV = numV + matmul(Xc.T, u_new)
        gramU = gramU + matmul(u_new.T, u_new)
        return (numV, gramU), u_new

    acc0 = (jnp.zeros((m, k), U.dtype), jnp.zeros((k, k), U.dtype))
    (numV, gramU), ys = jax.lax.scan(
        body, acc0, (X.data, X.cols, X.rows, Up, vp))
    return ys.reshape(X.n_pad, k)[:n], numV, gramU
