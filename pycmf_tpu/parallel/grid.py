"""2-D grid-sharded CMF: X sharded over BOTH axes of a (rows × cols) mesh.

The 1-D layouts (parallel/sharded.py) shard either n (rows) or m (cols);
a problem that is jointly huge in n AND m has no 1-D layout whose
replicated factor fits a device. The grid layout (SURVEY.md §7
anticipated "double psum") shards:

    X[i,j] : (n/r, m/c) block on mesh position (i, j)
    U_i    : row-sharded over the ROW axis, replicated over COL
    V_j    : sharded over the COL axis (the shared dimension), replicated
             over ROW
    Y_j    : row-sharded over COL (Y's rows index m), Z replicated

Each factor's update terms reduce over the OTHER axis only — collectives
stay k-shaped ((n_loc,k)/(m_loc,k)/(k,k)) and axis-local:

    MU    U: numU_i = Σ_j X[i,j] V_j      → psum over COL;  VᵀV → COL
          Z: numZ   = Σ_j Y_jᵀ V_j        → psum over COL
          V: numV_j = Σ_i X[i,j]ᵀ U_i     → psum over ROW;  UᵀU → ROW
             (+ local Y_j Z — no collective)
    Newton: the same geometry through newton_update_factor's per-term
          `distributed` machinery — U's and Z's stacked (g, H, φ)
          contributions psum over COL, V's X-side over ROW while its
          Y-side stays local. Padded rows/cols carry explicit masks for
          sigmoid links (σ(0) = 0.5 is not a no-op); linear MU padding
          is exact under zeros and needs none.

Sparse X splits per-cell when a cell's dense copy would blow the densify
threshold; dense cells are used below it (same policy as the 1-D
layouts). Above it each cell stores either CSR (+ a precomputed local
transpose; segment-sum SpMM) or — auto-picked for sparse cells past the
threshold — a streamed chunked-COO layout (ops/chunked.py: scatter row
chunks into a reused dense buffer, dense matmuls per chunk).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.links import LINEAR
from ..ops.losses import penalty
from ..ops.matmul import FP8_DTYPES, gram, matmul
from ..solvers.common import Hyper, SolverConfig, run_solver_loop
from ..solvers.mu import mu_ratio_update
from ..solvers.newton import Term, newton_update_factor
from .mesh import COL_AXIS, ROW_AXIS, make_grid_mesh


def factor_grid(n_devices: int) -> tuple[int, int]:
    """Near-square (rows, cols) factorization of a device count."""
    r = int(np.sqrt(n_devices))
    while n_devices % r:
        r -= 1
    return r, n_devices // r


class _GridOps(NamedTuple):
    """Device operands; leading dims sharded per _grid_specs."""
    X: object             # dense (n_pad, m_pad) P(ROW, COL) | stacked
                          # per-cell CsrMatrix with (r, c) leading dims
    Y: jnp.ndarray        # (m_pad, r_dim)  P(COL, None); r_dim=0 when no Y
    a_sq: jnp.ndarray     # ()              replicated ‖X‖²
    nmask: jnp.ndarray    # (n_pad,)        P(ROW)  1.0 on real rows
    mmask: jnp.ndarray    # (m_pad,)        P(COL)  1.0 on real shared dims
    rsq_u: jnp.ndarray    # (n_pad, c)      P(ROW, COL) partial ‖xᵢ‖²
    rsq_v: jnp.ndarray    # (m_pad, r)      P(COL, ROW) partial ‖(Xᵀ)ᵢ‖²
    Xt: object = None     # stacked per-cell CsrMatrix of the LOCAL
                          # transposes (CSR cells only; dense uses Xl.T,
                          # chunked streams chunked_spmm_t — no Xt)


def _grid_specs(ops: _GridOps) -> _GridOps:
    def cell_spec(x):
        return None if x is None else P(ROW_AXIS, COL_AXIS)

    from ..ops.chunked import is_chunked

    y_spec = P(COL_AXIS) if is_chunked(ops.Y) else P(COL_AXIS, None)
    return _GridOps(P(ROW_AXIS, COL_AXIS), y_spec, P(),
                    P(ROW_AXIS), P(COL_AXIS),
                    P(ROW_AXIS, COL_AXIS), P(COL_AXIS, ROW_AXIS),
                    cell_spec(ops.Xt))


def _regrid(stk, r, c):
    """Reshape a stacked layout's leading device dim d = r·c to (r, c).

    The 1-D stackers (parallel/sharded, ops/chunked) own the per-block
    conversion and padding conventions; the grid variants flatten their
    cells row-major through them and re-view the leading dim here — a
    free device-side reshape, and one padding implementation per format."""
    if stk is None:
        return None
    leaves, aux = stk.tree_flatten()
    return type(stk).tree_unflatten(
        aux, tuple(x.reshape((r, c) + x.shape[1:]) for x in leaves))


def _stack_csr_grid(cells, dtype):
    """Stack an r×c grid of scipy CSR cells into one CsrMatrix whose
    leaves carry (r, c) leading dims (shard_map spec P(ROW, COL)).

    Padding conventions live in parallel/sharded._stack_csr_blocks
    (nnz arrays pad to the global max with sorted no-op entries)."""
    from .sharded import _stack_csr_blocks

    return _regrid(_stack_csr_blocks(
        [b for row in cells for b in row], dtype),
        len(cells), len(cells[0]))


def _local_cell(stk):
    """Inside shard_map: drop the (1, 1) leading device dims."""
    from ..ops.sparse import CsrMatrix

    return CsrMatrix(stk.data[0, 0], stk.indices[0, 0], stk.indptr[0, 0],
                     stk.row_ids[0, 0], stk.sq_norm[0, 0], stk.shape)


def _local_chunked_cell(stk):
    """Inside shard_map: drop a stacked ChunkedCoo's (1, 1) leading dims."""
    from ..ops.chunked import ChunkedCoo

    return ChunkedCoo(stk.data[0, 0], stk.cols[0, 0], stk.rows[0, 0],
                      stk.sq_norm[0, 0], stk.shape, stk.chunk_rows,
                      stk.true_nnz)


def _prepare_grid(X, Y, U0, V0, r, c, dtype, data_dtype=None,
                  sparse_cells: str = "csr", y_link: str = LINEAR):
    """data_dtype: storage dtype for the X/Y blocks (None = dtype); bf16
    halves each cell's data-pass traffic while factors, masks, and
    norms stay at ``dtype``/f32 (same contract as _prepare_rows).

    A scipy.sparse X is split into r×c cells stored per
    ``sparse_cells``: 'csr' (segment-sum SpMM, plus the cells' local
    transposes) or 'chunked' (streamed chunked-COO, ops/chunked.py — one
    row-chunked layout serves both orientations); dense X is zero-padded
    and block-sharded."""
    import scipy.sparse as sp

    ddt = dtype if data_dtype is None else data_dtype
    n, m = X.shape
    n_loc, m_loc = -(-n // r), -(-m // c)
    n_pad, m_pad = r * n_loc, c * m_loc
    k = U0.shape[1]
    U_pad = np.zeros((n_pad, k))
    U_pad[:n] = U0
    V_pad = np.zeros((m_pad, k))
    V_pad[:m] = V0
    Xtd = None
    if sp.issparse(X):
        Xc = sp.csr_matrix(X)
        cells = []
        for i in range(r):
            rowc = []
            for j in range(c):
                blk = Xc[i * n_loc: min((i + 1) * n_loc, n),
                         j * m_loc: min((j + 1) * m_loc, m)]
                if blk.shape[0] < n_loc:
                    blk = sp.vstack([blk, sp.csr_matrix(
                        (n_loc - blk.shape[0], blk.shape[1]))])
                if blk.shape[1] < m_loc:
                    blk = sp.hstack([blk, sp.csr_matrix(
                        (blk.shape[0], m_loc - blk.shape[1]))])
                rowc.append(sp.csr_matrix(blk))
            cells.append(rowc)
        if sparse_cells == "chunked":
            from ..ops.chunked import stack_chunked_grid

            # one row-chunked layout serves BOTH orientations (same
            # contract as the 1-D rows layout): the V-side terms stream
            # chunked_spmm_t over the SAME cells, so the transposed COO
            # payload is never built — half the upload and half the COO
            # device memory on exactly the jointly-huge problems the grid
            # targets
            Xd = stack_chunked_grid(cells, ddt)
            Xtd = None
        else:
            Xd = _stack_csr_grid(cells, ddt)
            Xtd = _stack_csr_grid(
                [[b.T.tocsr() for b in row] for row in cells], ddt)
        a_sq64 = np.asarray(Xc.multiply(Xc).sum())
        rsq_u = np.stack(
            [np.concatenate([np.asarray(
                cells[i][j].multiply(cells[i][j]).sum(axis=1)).ravel()
                for i in range(r)]) for j in range(c)], axis=1)
        rsq_v = np.stack(
            [np.concatenate([np.asarray(
                cells[i][j].multiply(cells[i][j]).sum(axis=0)).ravel()
                for j in range(c)]) for i in range(r)], axis=1)
    else:
        Xh = np.zeros((n_pad, m_pad), dtype=np.float64)
        Xh[:n, :m] = np.asarray(X)
        if ddt in FP8_DTYPES:
            # quantized-norms convention: fit-time norms describe the
            # STORED values (utils/validation._dense_coupled)
            Xh = Xh.astype(ddt).astype(np.float64)
        Xd = jnp.asarray(Xh, dtype=ddt)
        a_sq64 = np.sum(Xh * Xh)
        # fit-time partial row norms: rsq_u[i, j] = ‖X[i, block j]‖²
        # (completed by the φ psum over COL); rsq_v mirrors it for Xᵀ.
        rsq_u = np.stack(
            [(Xh[:, j * m_loc:(j + 1) * m_loc] ** 2).sum(axis=1)
             for j in range(c)], axis=1)
        rsq_v = np.stack(
            [(Xh[i * n_loc:(i + 1) * n_loc] ** 2).sum(axis=0)
             for i in range(r)], axis=1)
    # fp8 X keeps Y at bf16, same rule as the 1-D layouts / single-chip
    yddt = jnp.bfloat16 if ddt in FP8_DTYPES else ddt
    if Y is None:
        # zero-column placeholder: shard_map specs stay uniform and the
        # cfg.has_Y gate keeps it out of every computation
        Yd = jnp.zeros((m_pad, 0), dtype=yddt)
    elif sp.issparse(Y) and y_link != LINEAR:
        # sigmoid-linked sparse Y never densifies on the host: Y's rows
        # are the COL-sharded m axis — below the
        # threshold scatter_densify (nnz-only upload), above it (or
        # sparse_cells='chunked') each COL slice rides the chunked-COO
        # carrier, replicated over ROW (spec P(COL) in _grid_specs)
        from ..utils.validation import DENSIFY_THRESHOLD, scatter_densify

        Yp = sp.csr_matrix(Y)
        if Yp.shape[0] < m_pad:
            Yp = sp.vstack([Yp, sp.csr_matrix(
                (m_pad - Yp.shape[0], Yp.shape[1]))]).tocsr()
        y_bytes = m_pad * Y.shape[1] * jnp.dtype(yddt).itemsize
        if sparse_cells == "chunked" or y_bytes > DENSIFY_THRESHOLD:
            from ..ops.chunked import stack_chunked_blocks

            Yd = stack_chunked_blocks(
                [Yp[j * m_loc:(j + 1) * m_loc] for j in range(c)], yddt)
        else:
            Yd = scatter_densify(Yp, yddt)
    else:
        if sp.issparse(Y):
            import warnings

            warnings.warn(
                "shard_layout='grid' stores a LINEAR-linked sparse Y as "
                "dense COL-sharded blocks; the sparse Y was densified on "
                f"the host ({Y.shape[0]}x{Y.shape[1]}). Fine for label "
                "matrices; for a large sparse Y use shard_layout='rows'.",
                UserWarning, stacklevel=3)
            Y = np.asarray(Y.todense())
        Yh = np.zeros((m_pad, Y.shape[1]))
        Yh[:m] = np.asarray(Y)
        Yd = jnp.asarray(Yh, dtype=yddt)
    nmask = np.zeros((n_pad,))
    nmask[:n] = 1.0
    mmask = np.zeros((m_pad,))
    mmask[:m] = 1.0
    fdt = jnp.float32 if jnp.dtype(dtype) == jnp.dtype(jnp.bfloat16) \
        else dtype
    ops = _GridOps(
        Xd, Yd,
        jnp.asarray(a_sq64, dtype=fdt),
        jnp.asarray(nmask, dtype=dtype), jnp.asarray(mmask, dtype=dtype),
        jnp.asarray(rsq_u, dtype=fdt), jnp.asarray(rsq_v, dtype=fdt),
        Xtd)
    return (ops, jnp.asarray(U_pad, dtype=dtype),
            jnp.asarray(V_pad, dtype=dtype), n, m)


def _grid_local_x(ops: _GridOps):
    """Local (inside-shard_map) views: (Xl, Xtl). Dense Xtl is Xl.T;
    sparse/chunked cells carry precomputed local transposes."""
    from ..ops.chunked import is_chunked
    from ..ops.sparse import is_sparse

    if is_chunked(ops.X):
        # chunked cells carry NO transposed layout — V-side consumers
        # stream chunked_spmm_t over the forward layout instead
        return _local_chunked_cell(ops.X), None
    if is_sparse(ops.X):
        return _local_cell(ops.X), _local_cell(ops.Xt)
    return ops.X, ops.X.T


def _mu_grid_iter(ops: _GridOps, U, V, Z, cfg: SolverConfig, hyper: Hyper,
                  with_aux: bool = False):
    """One MU iteration on local blocks (inside shard_map). Pinned
    U → Z → V order (solvers/mu.py): V's numerator sees U_new.

    with_aux: also return the LOCAL (pre-psum) X-side V pair
    (X_cellᵀU_new, U_locᵀU_loc) — ROW-partials of (XᵀU, UᵀU). The carry
    stays local so iterations pay nothing extra; _aux_loss_grid psums the
    pair over ROW only at eval points (tiny vs the X pass it replaces)."""
    from ..ops.chunked import chunked_spmm, is_chunked
    from ..ops.sparse import is_sparse, spmm

    l1 = hyper.alpha * hyper.l1_ratio
    l2 = hyper.alpha * (1.0 - hyper.l1_ratio)
    eps = hyper.eps
    Yl = ops.Y
    Xl, Xtl = _grid_local_x(ops)

    def xmm(A, B):
        if is_chunked(A):
            return chunked_spmm(A, B)
        return spmm(A, B) if is_sparse(A) else matmul(A, B)

    VtV = (jax.lax.psum(gram(V), COL_AXIS)
           if (cfg.update_U or (cfg.has_Y and cfg.update_Z)) else None)
    if cfg.update_U:
        num = jax.lax.psum(xmm(Xl, V), COL_AXIS)
        U = mu_ratio_update(U, VtV, num, l1, l2, eps)
        # padding rows are 0·0/0 = NaN when l1 = eps = 0 — force exact
        # zeros before U enters the V-side psums (0·NaN = NaN)
        U = jnp.where(ops.nmask[:, None] > 0.5, U, 0.0)
    if cfg.has_Y and cfg.update_Z:
        num = jax.lax.psum(matmul(Yl.T, V), COL_AXIS)
        Z = mu_ratio_update(Z, VtV, num, l1, l2, eps)
    aux = None
    if cfg.update_V:
        if is_chunked(Xl):
            from ..ops.chunked import chunked_spmm_t

            num_loc = chunked_spmm_t(Xl, U)
        else:
            num_loc = xmm(Xtl, U)
        S_loc = gram(U)
        aux = (num_loc, S_loc)                   # ROW-partials, X-side
        num = jax.lax.psum(num_loc, ROW_AXIS)
        S = jax.lax.psum(S_loc, ROW_AXIS)
        if cfg.has_Y:
            num = num + matmul(Yl, Z)   # Y_j rows are local — no psum
            S = S + gram(Z)
        V = mu_ratio_update(V, S, num, l1, l2, eps)
        V = jnp.where(ops.mmask[:, None] > 0.5, V, 0.0)
    if with_aux:
        assert aux is not None, "with_aux requires update_V"
        return U, V, Z, aux
    return U, V, Z


def _newton_grid_iter(ops: _GridOps, U, V, Z, cfg: SolverConfig,
                      hyper: Hyper, rng, with_aux: bool = False):
    """One Newton iteration on the grid: U/Z psum their stacked (g, H, φ)
    over COL, V's X-side over ROW (Y-side local) — newton_update_factor's
    per-term `distributed` machinery, with column masks covering the
    padded axis for sigmoid links and partial fit-time row norms
    completed by the φ psums.

    with_aux: also return the V update's LOCAL linear-term (DB, BtB) =
    ROW-partials of (XᵀU_new, U_newᵀU_new) (term_cache; the distributed
    term's ctx is pre-psum by construction) for _aux_loss_grid's
    zero-extra-pass eval. Requires _grid_aux_ok_newton."""
    kU, kZ, kV = jax.random.split(rng, 3)
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio)
    from ..ops.chunked import is_chunked as _icky
    from ..ops.chunked import local_chunked as _lck

    # chunked sigmoid-Y carrier: each COL shard
    # streams its local Y row slice — Z via the transposed orientation,
    # V's Y-term forward (replicated over ROW)
    y_chunk = _icky(ops.Y)
    Yl = _lck(ops.Y) if y_chunk else ops.Y
    Xl, Xtl = _grid_local_x(ops)
    xmask = ops.mmask if cfg.x_link != LINEAR else None
    xtmask = ops.nmask if cfg.x_link != LINEAR else None
    ymask = ops.mmask if cfg.y_link != LINEAR else None

    if cfg.update_U:
        U = newton_update_factor(
            kU, U, (Term(Xl, V, ops.rsq_u[:, 0]),), (cfg.x_link,),
            hyper, non_negative=cfg.U_non_negative, distributed=(True,),
            masks=(xmask,), axis_name=COL_AXIS, **common)
        U = U * ops.nmask[:, None]  # keep padding rows exactly zero
    if cfg.has_Y and cfg.update_Z:
        from ..ops.chunked import ChunkedT

        Yt = ChunkedT(Yl) if y_chunk else Yl.T
        Z = newton_update_factor(
            kZ, Z, ((Yt, V),), (cfg.y_link,), hyper,
            non_negative=cfg.Z_non_negative, distributed=(True,),
            masks=(ymask,), axis_name=COL_AXIS, **common)
    aux = None
    if cfg.update_V:
        kV = jax.random.fold_in(kV, jax.lax.axis_index(COL_AXIS))
        from ..ops.chunked import is_chunked

        if is_chunked(Xl) and cfg.x_link == LINEAR \
                and cfg.sg_sample_ratio >= 1.0:
            # same contract as the rows layout's chunked V branch: local
            # XᵀU / UᵀU partials stream over the FORWARD layout (no
            # transposed COO payload exists); D is a placeholder the
            # linear link never reads, and the partial row norms are
            # completed by the φ psums over ROW
            from ..ops.chunked import chunked_spmm_t

            terms = (Term(Xl, U, ops.rsq_v[:, 0],
                          DB=chunked_spmm_t(Xl, U), BtB=gram(U)),)
        elif is_chunked(Xl) and cfg.x_link == LINEAR:
            # sampled linear term: the ChunkedT marker lets
            # newton_update_factor recompute the masked DB/BtB/col norms
            # under its per-cell draw (distributed over ROW, so the key
            # folds the ROW axis index — same schedule as dense cells)
            from ..ops.chunked import ChunkedT

            terms = (Term(ChunkedT(Xl), U, ops.rsq_v[:, 0]),)
        elif is_chunked(Xl):
            # sigmoid V term streamed over the forward chunks per cell
            # (ChunkedT orientation); the (G, H, φ) partials psum over
            # ROW with U's padding rows masked via xtmask below
            from ..ops.chunked import ChunkedT

            terms = (Term(ChunkedT(Xl), U),)
        else:
            terms = (Term(Xtl, U, ops.rsq_v[:, 0]),)
        links = (cfg.x_link,)
        dist = (True,)
        masks = (xtmask,)
        if cfg.has_Y:
            terms = terms + ((Yl, Z),)
            links = links + (cfg.y_link,)
            dist = dist + (False,)
            masks = masks + (None,)
        phi_aux = with_aux == "phi"
        out = newton_update_factor(
            kV, V, terms, links, hyper, non_negative=cfg.V_non_negative,
            distributed=dist, masks=masks, axis_name=ROW_AXIS,
            term_cache=0 if (with_aux and not phi_aux) else None,
            return_phi=phi_aux, **common)
        if phi_aux:
            # X-side φ already psummed over ROW inside the update; mask
            # the padding V rows, sum locally, psum over V's shard axis
            V, phi_rows = out
            aux = jax.lax.psum(jnp.sum(phi_rows * ops.mmask), COL_AXIS)
        elif with_aux:
            V, aux = out
        else:
            V = out
        V = V * ops.mmask[:, None]
    if with_aux:
        assert aux is not None, \
            ("phi-aux requires update_V" if with_aux == "phi" else
             "with_aux requires _grid_aux_ok_newton (linear full-batch "
             "X term through the generic V update)")
        return U, V, Z, aux
    return U, V, Z


def _loss_grid(ops: _GridOps, U, V, Z, cfg: SolverConfig, hyper: Hyper):
    """L(U,V,Z): linear terms via the factored identity with the
    double-sharded inner product psummed over BOTH axes; sigmoid terms as
    masked local residuals."""
    from ..ops.chunked import chunked_inner, is_chunked
    from ..ops.losses import streamed_inner
    from ..ops.sparse import is_sparse, sddmm_dot

    Yl = ops.Y
    Xl, _ = _grid_local_x(ops)
    # one psummed Gram serves both linear terms
    need_gv = cfg.x_link == LINEAR or (cfg.has_Y and cfg.y_link == LINEAR)
    gV = jax.lax.psum(gram(V), COL_AXIS) if need_gv else None
    if cfg.x_link == LINEAR:
        # factor-precision inner, block-streamed for bf16 data shards
        # (see _loss_rows); a_sq is the exact fit-time norm
        if is_chunked(ops.X):
            inner = chunked_inner(Xl, U, V)
        elif is_sparse(ops.X):
            inner = sddmm_dot(Xl, U, V)
        else:
            inner = streamed_inner(Xl, U, V)
        inner = jax.lax.psum(jax.lax.psum(inner, COL_AXIS), ROW_AXIS)
        gU = jax.lax.psum(gram(U), ROW_AXIS)
        x_term = 0.5 * (ops.a_sq - 2.0 * inner + jnp.sum(gU * gV))
    elif is_chunked(ops.X):
        # streamed masked sigmoid residual over the local cell (both
        # axes padded: row validity folds into the chunk masks, column
        # padding into col_mask)
        from ..ops.losses import _sigmoid_term

        x_term = jax.lax.psum(jax.lax.psum(
            _sigmoid_term(Xl, U, V, ops.nmask, col_mask=ops.mmask),
            COL_AXIS), ROW_AXIS)
    else:
        # X cells are dense here when the estimator densifies
        # sigmoid-linked Newton inputs at fit time (_matrix_sparse_mode)
        R = Xl - jax.nn.sigmoid(matmul(U, V.T))
        w = ops.nmask[:, None] * ops.mmask[None, :]
        x_term = 0.5 * jax.lax.psum(
            jax.lax.psum(jnp.sum(w * R * R), COL_AXIS), ROW_AXIS)
    loss = x_term + jax.lax.psum(
        penalty(U, hyper.alpha, hyper.l1_ratio), ROW_AXIS)
    loss = loss + jax.lax.psum(
        penalty(V, hyper.alpha, hyper.l1_ratio), COL_AXIS)
    if cfg.has_Y:
        if is_chunked(Yl):
            # streamed chunked sigmoid-Y carrier (linear Y never chunks)
            from ..ops.chunked import local_chunked
            from ..ops.losses import _sigmoid_term as _sig

            y_term = jax.lax.psum(
                _sig(local_chunked(Yl), V, Z, ops.mmask), COL_AXIS)
        else:
            Yf = Yl.astype(U.dtype) if Yl.dtype != U.dtype else Yl
            if cfg.y_link == LINEAR:
                y_sq = jax.lax.psum(jnp.sum(Yf * Yf), COL_AXIS)
                y_inner = jax.lax.psum(
                    jnp.sum(matmul(Yf.T, V) * Z), COL_AXIS)
                y_term = 0.5 * (y_sq - 2.0 * y_inner
                                + jnp.sum(gV * gram(Z)))
            else:
                R = Yf - jax.nn.sigmoid(matmul(V, Z.T))
                y_term = 0.5 * jax.lax.psum(
                    jnp.sum(ops.mmask[:, None] * R * R), COL_AXIS)
        loss = loss + y_term + penalty(Z, hyper.alpha, hyper.l1_ratio)
    return loss


def _aux_loss_grid(cfg: SolverConfig, ops: _GridOps):
    """Loss from the step's LOCAL X-side V pair — no pass over X.

    The aux carries ROW-partials (see _mu_grid_iter/_newton_grid_iter), so
    iterations pay nothing; here, only at eval points, the pair psums over
    ROW — an (m_loc, k) + (k, k) collective in place of _loss_grid's full
    X stream — and the factored identity gives the x-term exactly as
    _loss_grid's linear branch does (ops.a_sq is the exact fit-time norm)."""

    def loss_fn(state, aux, hyper: Hyper):
        _, __, U, V, Z = state
        num_loc, S_loc = aux
        num = jax.lax.psum(num_loc, ROW_AXIS)    # (m_loc, k) XᵀU block
        S = jax.lax.psum(S_loc, ROW_AXIS)        # global UᵀU
        gV = jax.lax.psum(gram(V), COL_AXIS)
        inner = jax.lax.psum(jnp.sum(num * V), COL_AXIS)
        x_term = 0.5 * (ops.a_sq - 2.0 * inner + jnp.sum(S * gV))
        loss = x_term + jax.lax.psum(
            penalty(U, hyper.alpha, hyper.l1_ratio), ROW_AXIS)
        loss = loss + jax.lax.psum(
            penalty(V, hyper.alpha, hyper.l1_ratio), COL_AXIS)
        if cfg.has_Y:
            from ..ops.chunked import is_chunked as _icky

            Yl = ops.Y
            if _icky(Yl):
                from ..ops.chunked import local_chunked
                from ..ops.losses import _sigmoid_term as _sig

                y_term = jax.lax.psum(
                    _sig(local_chunked(Yl), V, Z, ops.mmask), COL_AXIS)
            else:
                Yf = Yl.astype(U.dtype) if Yl.dtype != U.dtype else Yl
                if cfg.y_link == LINEAR:
                    y_sq = jax.lax.psum(jnp.sum(Yf * Yf), COL_AXIS)
                    y_inner = jax.lax.psum(
                        jnp.sum(matmul(Yf.T, V) * Z), COL_AXIS)
                    y_term = 0.5 * (y_sq - 2.0 * y_inner
                                    + jnp.sum(gV * gram(Z)))
                else:
                    R = Yf - jax.nn.sigmoid(matmul(V, Z.T))
                    y_term = 0.5 * jax.lax.psum(
                        jnp.sum(ops.mmask[:, None] * R * R), COL_AXIS)
            loss = loss + y_term + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _grid_aux_ok(cfg: SolverConfig, ops: _GridOps, V) -> bool:
    """Grid aux loss: same qualification rules as the 1-D layouts — both
    U and V updating (the V step computes the pair either way), linear
    x_link (the factored identity), and no small mixed-precision dense X
    (identity cancellation at data precision)."""
    from ..ops.chunked import is_chunked
    from ..ops.sparse import is_sparse

    if not (cfg.update_U and cfg.update_V and cfg.x_link == LINEAR):
        return False
    if is_chunked(ops.X) or is_sparse(ops.X):
        return True
    if ops.X.dtype != V.dtype and ops.X.size < (1 << 22):
        return False
    return True


def _grid_aux_ok_newton(cfg: SolverConfig, ops: _GridOps, V) -> bool:
    """Newton grid aux additionally needs the full-batch V update (a
    sampled term's DB/BtB describe the subsample) — see
    parallel/sharded._cols_aux_ok_newton."""
    return (_grid_aux_ok(cfg, ops, V) and cfg.sg_sample_ratio >= 1.0
            and cfg.hessian_form == "gauss")


def _aux_loss_grid_phi(cfg: SolverConfig):
    """φ-aux eval loss, grid layout: the iter already masked padding V
    rows, psummed the X side over ROW (inside the line search) and the
    masked row sums over COL — the aux is L_X + L_Y + R(V) exactly. Add the ROW-sharded U's
    psummed penalty and the replicated Z's once."""

    def loss_fn(state, aux, hyper: Hyper):
        _, __, U, V, Z = state
        loss = aux + jax.lax.psum(
            penalty(U, hyper.alpha, hyper.l1_ratio), ROW_AXIS)
        if cfg.has_Y:
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_fns_grid(cfg: SolverConfig, ops, aux):
    from .sharded import _aux_zero_pair, _phi_zero

    if aux == "phi":
        return _aux_loss_grid_phi(cfg), _phi_zero
    return _aux_loss_grid(cfg, ops), _aux_zero_pair


def _grid_aux_kind(cfg: SolverConfig, ops: _GridOps, V, solver: str):
    """None | "factored" | "phi" — the grid mirror of
    parallel/sharded._rows_aux_kind (see solvers/newton._aux_kind)."""
    if solver == "mu" or cfg.x_link == LINEAR:
        ok = (_grid_aux_ok(cfg, ops, V) if solver == "mu"
              else _grid_aux_ok_newton(cfg, ops, V))
        return "factored" if ok else None
    if not (cfg.update_V and cfg.line_search_trials >= 1
            and cfg.sg_sample_ratio >= 1.0):
        return None
    return "phi"


def _make_grid_device_fit(cfg: SolverConfig, mesh, solver: str, ospec,
                          aux: bool = False):
    """Whole tol loop inside shard_map: every device runs the while_loop
    in lockstep, synchronized by the psums — one dispatch per fit (same
    contract as parallel/sharded._make_rows_device_fit)."""
    from ..solvers.common import device_fit_core

    in_specs = (ospec, P(ROW_AXIS, None), P(COL_AXIS, None), P(), P(),
                P(), P())
    out_specs = (P(ROW_AXIS, None), P(COL_AXIS, None), P(), P(), P())

    from .sharded import _aux_zero_pair

    def make_core(ops):
        def step_fn(_, __, U, V, Z, hyper, key=None):
            if solver == "mu":
                return _mu_grid_iter(ops, U, V, Z, cfg, hyper,
                                     with_aux=aux)
            return _newton_grid_iter(ops, U, V, Z, cfg, hyper, key,
                                     with_aux=aux)

        def loss_core(state, hyper):
            _, __, U, V, Z = state
            return _loss_grid(ops, U, V, Z, cfg, hyper)

        aux_loss, aux_init = _aux_fns_grid(cfg, ops, aux)
        return device_fit_core(
            step_fn, loss_core, carry_rng=(solver != "mu"),
            aux_loss=aux_loss if aux else None,
            aux_init=aux_init if aux else None)

    @partial(jax.jit, static_argnames=("max_iter", "eval_every"))
    def fit(ops, U, V, Z, hyper, rng, tol, max_iter, eval_every):
        def body(ops, U, V, Z, hyper, rng, tol):
            core = make_core(ops)
            return core(None, None, U, V, Z, hyper, rng, tol, max_iter,
                        eval_every)

        sm = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        return sm(ops, U, V, Z, hyper, rng, tol)

    return fit


def _make_grid_block(cfg: SolverConfig, mesh, solver: str, ospec,
                     aux: bool = False):
    from .sharded import _aux_zero_pair

    in_specs = (ospec, P(ROW_AXIS, None), P(COL_AXIS, None), P(), P(), P())
    out_specs = ((P(ROW_AXIS, None), P(COL_AXIS, None), P()), P(), P())

    def body(ops, U, V, Z, hyper, rng, n_steps):
        key, off = rng
        aux_loss, aux_init = _aux_fns_grid(cfg, ops, aux)

        def one(i, carry):
            U, V, Z, _a = carry
            if solver == "mu":
                out = _mu_grid_iter(ops, U, V, Z, cfg, hyper,
                                    with_aux=aux)
            else:
                out = _newton_grid_iter(ops, U, V, Z, cfg, hyper,
                                        jax.random.fold_in(key, off + i),
                                        with_aux=aux)
            return out if aux else out + (_a,)

        U, V, Z, a = jax.lax.fori_loop(
            0, n_steps, one, (U, V, Z, aux_init(U, V, Z)))
        if aux:
            loss = aux_loss((ops, None, U, V, Z), a, hyper)
        else:
            loss = _loss_grid(ops, U, V, Z, cfg, hyper)
        return (U, V, Z), loss, (key, off + n_steps)

    @partial(jax.jit, static_argnames=("n_steps",))
    def block(state, hyper, rng, n_steps):
        ops, U, V, Z = state
        sm = jax.shard_map(partial(body, n_steps=n_steps), mesh=mesh,
                           in_specs=in_specs, out_specs=out_specs,
                           check_vma=False)
        (U, V, Z), loss, rng = sm(ops, U, V, Z, hyper, rng)
        return (ops, U, V, Z), loss, rng

    def loss_fn(state, hyper):
        ops, U, V, Z = state
        sm = jax.shard_map(
            lambda ops, U, V, Z, h: _loss_grid(ops, U, V, Z, cfg, h),
            mesh=mesh, in_specs=in_specs[:5], out_specs=P(),
            check_vma=False)
        return sm(ops, U, V, Z, hyper)

    return block, jax.jit(loss_fn)


def run_grid(X, Y, U0, V0, Z0, cfg: SolverConfig, hyper: Hyper, *,
             grid: tuple[int, int], dtype=jnp.float32, mesh=None,
             max_iter: int = 200, tol: float = 1e-4, eval_every: int = 10,
             verbose: int = 0, solver: str = "mu", rng=None,
             loop: str = "host", data_dtype=None,
             sparse_mode: str = "auto"):
    """Grid-sharded fit driver. Returns the run_mu tuple.

    grid=(rows, cols) must multiply to the mesh's device count. MU needs
    linear links (validated by the estimator); Newton supports sigmoid
    links via the padding masks. loop='device' runs the whole tol loop
    inside shard_map (one dispatch per fit).

    Sparse X: 'auto' densifies on the host when each CELL's dense
    storage fits the threshold (each device holds only its dense cell);
    above it cells stream as chunked-COO. 'csr' / 'chunked' / 'dense'
    force the respective layout.
    """
    import time as _time

    import scipy.sparse as sp

    from ..solvers.common import amortize_step_times, finish_device_fit

    r, c = grid
    if mesh is None:
        mesh = make_grid_mesh(r, c)
    sparse_cells = "csr"
    if sp.issparse(X):
        # chunked cells serve MU and Newton alike — stochastic Newton
        # (sg_sample_ratio < 1) enters the streamed terms as a per-cell
        # column mask (solvers/newton.sample_mask)
        if sparse_mode == "chunked":
            sparse_cells = "chunked"
        elif sparse_mode != "csr":
            from ..utils.validation import DENSIFY_THRESHOLD

            item = (jnp.dtype(data_dtype).itemsize
                    if data_dtype is not None
                    else jnp.dtype(dtype).itemsize)
            cell = (-(-X.shape[0] // r)) * (-(-X.shape[1] // c)) * item
            if sparse_mode == "dense" or cell <= DENSIFY_THRESHOLD:
                # each device holds only its dense cell; the HOST
                # materializes the full matrix while splitting
                X = np.asarray(X.todense())
            else:
                # over-threshold cells stream as chunked-COO
                sparse_cells = "chunked"
    # a sparse Y passes through to _prepare_grid, which owns the policy:
    # sigmoid link never densifies on the host (scatter_densify below the
    # threshold, the chunked-COO carrier above it); linear link densifies
    # with a warning (dense COL-sharded blocks are its only layout here)
    if data_dtype is not None and data_dtype in FP8_DTYPES:
        # fp8 is a dense-storage format only — same rule as as_coupled /
        # run_sharded (per-cell CSR/chunked layouts have no fp8
        # promotion path)
        if sp.issparse(X):
            raise ValueError(
                "fp8 data storage requires dense device cells, but X "
                f"stays sparse under sparse_mode={sparse_mode!r} at this "
                "cell size; use data_dtype='bfloat16' or a bigger grid")
        from ..utils.validation import check_fp8_range

        check_fp8_range(X, data_dtype)
    ops, U_pad, V_pad, n, m = _prepare_grid(X, Y, U0, V0, r, c, dtype,
                                            data_dtype=data_dtype,
                                            sparse_cells=sparse_cells,
                                            y_link=cfg.y_link)
    k = U_pad.shape[1]
    Z = (jnp.asarray(Z0, dtype=dtype) if Z0 is not None and cfg.has_Y
         else jnp.zeros((0, k), dtype=dtype))
    if rng is None:
        rng = jax.random.PRNGKey(0)
    from .sharded import place_operands

    specs = _grid_specs(ops)
    ops = place_operands(ops, specs, mesh)
    aux = _grid_aux_kind(cfg, ops, V_pad, solver)
    if loop == "device":
        fitf = _make_grid_device_fit(cfg, mesh, solver, specs, aux)
        t0 = _time.perf_counter()
        out = fitf(ops, U_pad, V_pad, Z, hyper, rng,
                   jnp.asarray(tol, dtype), max_iter, eval_every)
        U, V, Z, n_iter, losses, iters = finish_device_fit(
            out, eval_every, max_iter)
        return (U[:n], V[:m], Z, n_iter, losses, iters,
                amortize_step_times(_time.perf_counter() - t0, iters))
    block, loss_fn = _make_grid_block(cfg, mesh, solver, specs, aux)
    state = (ops, U_pad, V_pad, Z)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, state, hyper, (rng, jnp.zeros((), jnp.int32)),
        max_iter=max_iter, tol=tol, eval_every=eval_every,
        verbose=verbose, initial_loss_fn=loss_fn)
    _, U, V, Z = state
    return U[:n], V[:m], Z, n_iter, losses, iters, times
