"""Multi-chip CMF: row-sharded solvers over a 1-D device mesh.

This is the build's distributed-communication component (SURVEY.md §5: the
reference has none; here it is XLA collectives inside shard_map, which
run over NVLink between the cards of one host). Two layouts, per
SURVEY.md §7 stage 6:

- layout "rows" (A): shard X's rows (n) — U co-sharded, V/Z/Y replicated.
  Each iteration all-reduces (psum over the mesh axis) the shared-V
  numerator+denominator terms (MU: XᵀU and UᵀU) or the stacked per-row
  gradient/Hessian/line-search contributions (Newton), exactly the
  communication pattern BASELINE.json mandates ("row-sharded X/Y across
  chips with shared-V all-reduce").
- layout "cols" (B): shard the coupled dimension m — X col-sharded,
  Y row-sharded, V co-sharded, U/Z replicated; psums move to U's and Z's
  update terms (MU: X·V and VᵀV; Newton: stacked g/H/φ — _newton_cols_iter).
  For problems whose shared dimension dwarfs n.

Sparse CSR data is pre-split on the host into per-device CSR blocks whose
nonzero arrays are padded to a common length (static shapes on every chip);
padding entries carry value 0 at the last local row, so every segment-sum
and SDDMM ignores them. Dense data is zero-padded to a divisible row count;
zero rows are exact no-ops for linear links, and sigmoid paths receive an
explicit row mask.

The same pure solver math runs inside ``shard_map`` — sharding is a property
of the operands, not of the algorithm (SURVEY.md §7 design stance).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import PartitionSpec as P

from ..ops.links import LINEAR
from ..ops.losses import penalty, reconstruction_term
from ..ops.matmul import FP8_DTYPES, gram, matmul
from ..ops.sparse import CsrMatrix, is_sparse, sddmm_dot, spmm
from ..solvers.common import Hyper, SolverConfig, run_solver_loop
from ..solvers.mu import mu_ratio_update
from ..solvers.newton import newton_update_factor
from .mesh import AXIS, make_mesh

# ---------------------------------------------------------------------------
# Host-side operand preparation
# ---------------------------------------------------------------------------


def _stack_csr_blocks(blocks, dtype) -> CsrMatrix:
    """Stack per-device scipy CSR blocks into one leading-dim-d CsrMatrix.

    All blocks must share .shape (the LOCAL shape). nnz arrays are padded to
    the max block nnz with (data=0, col=0, row=last_row) so padding entries
    are sorted no-ops for segment ops.
    """
    local_shape = blocks[0].shape
    rows = local_shape[0]
    datas, idxs, ptrs, rids, sqs = [], [], [], [], []
    nnz_max = max(1, max(b.nnz for b in blocks))
    for b in blocks:
        b = sp.csr_matrix(b)
        b.sum_duplicates()
        pad = nnz_max - b.nnz
        data = np.pad(np.asarray(b.data, dtype=np.float64), (0, pad))
        cols = np.pad(np.asarray(b.indices, dtype=np.int32), (0, pad))
        rid = np.repeat(np.arange(rows, dtype=np.int32), np.diff(b.indptr))
        rid = np.pad(rid, (0, pad), constant_values=rows - 1)
        datas.append(data)
        idxs.append(cols)
        ptrs.append(np.asarray(b.indptr, dtype=np.int32))
        rids.append(rid)
        sqs.append(np.sum(np.asarray(b.data, dtype=np.float64) ** 2))
    sq_dt = jnp.float32 if jnp.dtype(dtype) == jnp.dtype(jnp.bfloat16) \
        else dtype
    return CsrMatrix(
        jnp.asarray(np.stack(datas), dtype=dtype),
        jnp.asarray(np.stack(idxs)),
        jnp.asarray(np.stack(ptrs)),
        jnp.asarray(np.stack(rids)),
        jnp.asarray(np.asarray(sqs), dtype=sq_dt),
        local_shape,
    )


def _local_csr(stk: CsrMatrix) -> CsrMatrix:
    """Inside shard_map: drop the (length-1) leading device dim."""
    return CsrMatrix(stk.data[0], stk.indices[0], stk.indptr[0],
                     stk.row_ids[0], stk.sq_norm[0], stk.shape)


class _RowOperands(NamedTuple):
    """Device operands for the rows layout (leading dims sharded over AXIS)."""
    X: object            # dense (n_pad, m) | stacked CsrMatrix (d, ...)
                         # | stacked ChunkedCoo (streaming layout)
    Xt: object           # None (dense/chunked) | stacked CsrMatrix of
                         # local transposes (chunked needs none: both
                         # orientations stream from one layout)
    Y: object            # replicated dense (m, r) | CsrMatrix | None
    Yt: object
    mask: jnp.ndarray    # (n_pad,) 1.0 on real rows
    row_sq: object = None    # (n_pad,) per-row ‖xᵢ‖² (Newton line search)
    row_sq_t: object = None  # (d, m) per-shard col-block norms of Xᵀ rows
    row_sq_t_glob: object = None  # (m,) GLOBAL ‖(Xᵀ)ᵢ‖², replicated


class _ColOperands(NamedTuple):
    """Device operands for the cols layout (the shared dim m sharded)."""
    X: object            # dense (n, m_loc) local | stacked CsrMatrix (d, ...)
    Xt: object           # None (dense) | stacked CsrMatrix of local (m_loc,n)
    Y: object            # dense (m_loc, r) local rows | None
    mask: jnp.ndarray    # (m_pad,) 1.0 on real shared-dim entries
    row_sq: object = None    # (n,) PARTIAL ‖xᵢ‖² over local cols (psummed φ)
    row_sq_t: object = None  # (m_loc,) EXACT ‖(Xᵀ)ᵢ‖² (local Xᵀ rows are full)


def place_operands(ops, specs, mesh):
    """Put every device operand on the mesh under its shard_map spec.

    The prepare functions build stacked arrays on the default device; a
    jit over shard_map would otherwise re-split them from there on every
    call and keep the whole stack on the first device. After this each
    device holds only its own shard (replicated specs copy to all)."""
    from jax.sharding import NamedSharding

    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    return jax.device_put(ops, shardings)


def _aux_zero_pair(U, V, Z):
    """Zero aux pair for the factored eval loss: (XᵀU-shaped, UᵀU-shaped).
    Inside shard_map V is the local shard on the cols layout, so the same
    helper serves both layouts (rows: global (m,k); cols: local (m_loc,k))."""
    k = U.shape[1]
    return (jnp.zeros_like(V), jnp.zeros((k, k), U.dtype))


def _prepare_rows(X, Y, U0, d, dtype, data_dtype=None,
                  chunked: str = "never", y_link: str = LINEAR):
    """Split X by rows into d blocks; pad; build transposes per block.

    data_dtype: storage dtype for the X/Y shards (None = dtype). bf16
    halves each device's data-pass traffic exactly as on one device;
    factors, masks, and norms stay at ``dtype``/f32.

    chunked: 'never' (per-shard CSR) | 'auto' / 'force' (per-shard
    streamed chunked-COO: sparse shards too big to densify locally, or
    sparse_mode='chunked') — applies to X; a
    SIGMOID-linked sparse Y (replicated in this layout) follows the same
    policy on its own size: device-densify when the dense copy fits the
    threshold, else (or under 'force') the replicated chunked-COO carrier
    whose streamed terms the Newton updates consume — no dense Y ever
    exists, on host or device.

    y_link: the Y matrix's link — sigmoid Y cannot stay CSR (sigmoid
    terms need dense or chunked data)."""
    ddt = dtype if data_dtype is None else data_dtype
    n, m = X.shape
    n_loc = -(-n // d)
    n_pad = d * n_loc
    mask = np.zeros((n_pad,), dtype=np.float64)
    mask[:n] = 1.0

    if sp.issparse(X):
        X = sp.csr_matrix(X)
        blocks = []
        for i in range(d):
            blk = X[i * n_loc: min((i + 1) * n_loc, n)]
            if blk.shape[0] < n_loc:  # pad empty rows
                blk = sp.vstack([blk, sp.csr_matrix(
                    (n_loc - blk.shape[0], m))]).tocsr()
            blocks.append(blk)
        if chunked in ("auto", "force"):
            # Per-shard streaming chunked-COO (ops/chunked.py): one
            # layout serves BOTH orientations; no CSR upload at all.
            from ..ops.chunked import stack_chunked_blocks

            Xd = stack_chunked_blocks(blocks, ddt)
            Xtd = None
        else:
            Xd = _stack_csr_blocks(blocks, ddt)
            Xtd = _stack_csr_blocks([b.T.tocsr() for b in blocks], ddt)
    else:
        Xh = np.zeros((n_pad, m), dtype=np.float64)
        Xh[:n] = np.asarray(X)
        if ddt in FP8_DTYPES:
            # quantized-norms convention: the fit-time norms below must
            # describe the STORED values (utils/validation._dense_coupled)
            Xh = Xh.astype(ddt).astype(np.float64)
        Xd = jnp.asarray(Xh, dtype=ddt)
        Xtd = None

    # fp8 storage is for the BIG matrix only (same rule as the single-chip
    # fit conversion): the small Y stays bf16 — quantizing it saves nothing
    # and costs label precision.
    yddt = jnp.bfloat16 if ddt in FP8_DTYPES else ddt
    if Y is None:
        Yd = Ytd = None
    elif sp.issparse(Y):
        if y_link != LINEAR:
            from ..utils.validation import (DENSIFY_THRESHOLD,
                                            scatter_densify)

            y_bytes = Y.shape[0] * Y.shape[1] * jnp.dtype(yddt).itemsize
            if chunked == "force" or y_bytes > DENSIFY_THRESHOLD:
                from ..ops.chunked import chunked_from_scipy

                Yd, Ytd = chunked_from_scipy(Y, dtype=yddt), None
            else:
                Yd, Ytd = scatter_densify(Y, yddt), None
        else:
            from ..ops.sparse import csr_transpose_host

            Yd, Ytd = csr_transpose_host(Y, yddt)
    else:
        Yd = jnp.asarray(np.asarray(Y), dtype=yddt)
        Ytd = None

    # fit-time per-row norms (constant across iterations)
    if sp.issparse(X):
        rs = np.zeros((n_pad,))
        rs[:n] = np.asarray(X.multiply(X).sum(axis=1)).ravel()
        rst = np.stack([
            np.asarray(b.multiply(b).sum(axis=0)).ravel() for b in blocks])
    else:
        # norms from the HOST array: device_get(Xd) would copy the whole
        # dense matrix back from the device, and quantized (bf16)
        # norms would diverge from the single-chip convention (exact norms
        # from the unquantized input — as_coupled._dense_coupled)
        rs = np.einsum("ij,ij->i", Xh, Xh)   # Xh is already float64
        rst = np.stack([
            np.einsum("ij,ij->j", Xh[i * n_loc:(i + 1) * n_loc],
                      Xh[i * n_loc:(i + 1) * n_loc]) for i in range(d)])

    U_pad = np.zeros((n_pad, U0.shape[1]), dtype=np.float64)
    U_pad[:n] = U0
    fdt = jnp.float32 if jnp.dtype(dtype) == jnp.dtype(jnp.bfloat16) \
        else dtype
    ops = _RowOperands(Xd, Xtd, Yd, Ytd, jnp.asarray(mask, dtype=dtype),
                       jnp.asarray(rs, dtype=fdt),
                       jnp.asarray(rst, dtype=fdt),
                       jnp.asarray(rst.sum(axis=0), dtype=fdt))
    return ops, jnp.asarray(U_pad, dtype=dtype), n


def _prepare_cols(X, Y, V0, d, dtype, data_dtype=None,
                  chunked: str = "never", y_link: str = LINEAR):
    """Split the shared dimension m into d blocks (layout B).

    Returns (ops, V_pad, m): ops.mask is (m_pad,) with 1.0 on real
    shared-dimension entries (sigmoid terms need it; linear terms are exact
    no-ops under zero padding). data_dtype / chunked: see _prepare_rows
    (here the streamed layout row-chunks each shard's (n, m_loc) column
    slice — both MU numerators and the Newton linear terms stream it).

    y_link: a SIGMOID-linked sparse Y (whose rows ARE the sharded m axis
    here) never densifies on the host: below the
    densify threshold it device-densifies via scatter_densify (nnz-only
    upload), above it (or under chunked='force') each shard's row slice
    rides the per-shard chunked-COO carrier — the same streamed sigmoid
    term machinery X uses, with Z consuming the transposed orientation
    and V's Y-term the forward one."""
    ddt = dtype if data_dtype is None else data_dtype
    n, m = X.shape
    m_loc = -(-m // d)
    m_pad = d * m_loc
    mask = np.zeros((m_pad,), dtype=np.float64)
    mask[:m] = 1.0

    if sp.issparse(X):
        Xc = sp.csc_matrix(X)
        blocks = []
        for i in range(d):
            lo, hi = i * m_loc, min((i + 1) * m_loc, m)
            blk = Xc[:, lo:hi]
            if blk.shape[1] < m_loc:
                blk = sp.hstack([blk, sp.csc_matrix(
                    (n, m_loc - blk.shape[1]))])
            blocks.append(sp.csr_matrix(blk))
        # transposed blocks are built only for CSR: the chunked layout
        # never reads them (one forward layout serves both orientations)
        if chunked in ("auto", "force"):
            # Per-shard streaming chunked-COO: one row-chunked layout of
            # the local column slice serves both orientations (forward
            # chunks feed chunked_spmm AND chunked_spmm_t).
            from ..ops.chunked import stack_chunked_blocks

            Xd = stack_chunked_blocks(blocks, ddt)
            Xtd = None
        else:
            Xd = _stack_csr_blocks(blocks, ddt)     # local (n, m_loc)
            Xtd = _stack_csr_blocks(                # local (m_loc, n)
                [sp.csr_matrix(b.T) for b in blocks], ddt)
        # fit-time norms: local X rows are column SLICES (partial — the φ
        # psum completes them); local Xᵀ rows are full rows of Xᵀ (exact).
        rs = np.stack([
            np.asarray(b.multiply(b).sum(axis=1)).ravel() for b in blocks])
        rst = np.stack([
            np.asarray(b.multiply(b).sum(axis=0)).ravel() for b in blocks])
    else:
        Xh = np.zeros((n, m_pad), dtype=np.float64)
        Xh[:, :m] = np.asarray(X)
        if ddt in FP8_DTYPES:
            # quantized-norms convention (see _prepare_rows)
            Xh = Xh.astype(ddt).astype(np.float64)
        Xd = jnp.asarray(Xh, dtype=ddt)
        Xtd = None
        rs = np.stack([(Xh[:, i * m_loc:(i + 1) * m_loc] ** 2).sum(axis=1)
                       for i in range(d)])
        rst = np.stack([(Xh[:, i * m_loc:(i + 1) * m_loc] ** 2).sum(axis=0)
                        for i in range(d)])

    yddt = jnp.bfloat16 if ddt in FP8_DTYPES else ddt  # same rule as rows
    if Y is None:
        Yd = None
    elif sp.issparse(Y) and y_link != LINEAR:
        from ..utils.validation import DENSIFY_THRESHOLD, scatter_densify

        Yp = sp.csr_matrix(Y)
        if Yp.shape[0] < m_pad:   # pad empty rows to the sharded m
            Yp = sp.vstack([Yp, sp.csr_matrix(
                (m_pad - Yp.shape[0], Yp.shape[1]))]).tocsr()
        y_bytes = m_pad * Y.shape[1] * jnp.dtype(yddt).itemsize
        if chunked == "force" or y_bytes > DENSIFY_THRESHOLD:
            from ..ops.chunked import stack_chunked_blocks

            yblocks = [Yp[i * m_loc:(i + 1) * m_loc] for i in range(d)]
            Yd = stack_chunked_blocks(yblocks, yddt)
        else:
            # device-side densify: only the nnz are copied to the device
            # and no dense Y ever exists on the host (mirrors _prepare_rows)
            Yd = scatter_densify(Yp, yddt)
    else:
        if sp.issparse(Y):
            import warnings

            warnings.warn(
                "shard_layout='cols' stores a LINEAR-linked sparse Y as a "
                "dense row-sharded block on each device; the sparse Y was "
                f"densified on the host ({Y.shape[0]}x{Y.shape[1]}). Fine "
                "for label matrices; for a large sparse Y use "
                "shard_layout='rows' (keeps Y CSR).",
                UserWarning, stacklevel=3)
            Y = np.asarray(Y.todense())
        Yh = np.zeros((m_pad, Y.shape[1]), dtype=np.float64)
        Yh[:m] = np.asarray(Y)
        Yd = jnp.asarray(Yh, dtype=yddt)

    V_pad = np.zeros((m_pad, V0.shape[1]), dtype=np.float64)
    V_pad[:m] = V0
    fdt = jnp.float32 if jnp.dtype(dtype) == jnp.dtype(jnp.bfloat16) \
        else dtype
    ops = _ColOperands(Xd, Xtd, Yd, jnp.asarray(mask, dtype=dtype),
                       jnp.asarray(rs, dtype=fdt),
                       jnp.asarray(rst, dtype=fdt))
    return ops, jnp.asarray(V_pad, dtype=dtype), m


# ---------------------------------------------------------------------------
# Sharded loss (rows layout)
# ---------------------------------------------------------------------------


def _loss_rows(ops: _RowOperands, U, V, Z, mask, cfg: SolverConfig,
               hyper: Hyper):
    """L(U,V,Z) with U and X row-sharded: psum the X-side contributions."""
    from ..ops.chunked import chunked_inner, is_chunked, local_chunked

    if cfg.x_link == LINEAR:
        if is_chunked(ops.X):
            Xl = local_chunked(ops.X)
            a_sq = Xl.sq_norm
            inner = chunked_inner(Xl, U, V)
        elif is_sparse(ops.X):
            Xl = _local_csr(ops.X)
            a_sq = Xl.sq_norm
            inner = sddmm_dot(Xl, U, V)
        else:
            # exact fit-time norms (f32/f64) — summing bf16/fp8 squares at
            # data precision would bias the loss — and a factor-precision
            # inner: the factored identity cancels large terms, so the bf16
            # matmul path's quantization of V would bias the result.
            # streamed_inner upcasts X block-wise (no whole-shard f32 copy).
            from ..ops.losses import streamed_inner

            a_sq = jnp.sum(ops.row_sq)
            inner = streamed_inner(ops.X, U, V)
        gU = jax.lax.psum(gram(U), AXIS)
        part = jax.lax.psum(a_sq - 2.0 * inner, AXIS)
        x_term = 0.5 * (part + jnp.sum(gU * gram(V)))
    else:
        if is_chunked(ops.X):
            # streamed per-chunk residual; the shard's padding rows fold
            # into the chunk scan's mask (ops/losses.py)
            x_term = jax.lax.psum(reconstruction_term(
                local_chunked(ops.X), U, V, cfg.x_link,
                row_mask=mask), AXIS)
        else:
            R = ops.X - jax.nn.sigmoid(matmul(U, V.T))
            x_term = 0.5 * jax.lax.psum(
                jnp.sum(mask[:, None] * R * R), AXIS)

    loss = x_term + jax.lax.psum(penalty(U, hyper.alpha, hyper.l1_ratio),
                                 AXIS)
    loss = loss + penalty(V, hyper.alpha, hyper.l1_ratio)
    if cfg.has_Y:
        loss = loss + reconstruction_term(ops.Y, V, Z, cfg.y_link)
        loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
    return loss


def _aux_loss_rows(cfg: SolverConfig):
    """Loss from the step's already-psummed X-side V terms — no pass over X
    and no extra collective beyond the scalar reductions.

    Mirrors solvers/mu.py:_aux_loss for the rows layout: a_sq and U's
    penalty are psummed over shards; the aux pair (ΣXᵀU, ΣUᵀU) is already
    global; V/Z/Y terms are replicated.
    """

    def loss_fn(state, aux, hyper: Hyper):
        ops, _, U, V, Z = state
        num, S = aux
        a_sq = jax.lax.psum(jnp.sum(ops.row_sq), AXIS)
        inner = jnp.sum(num * V)
        x_term = 0.5 * (a_sq - 2.0 * inner + jnp.sum(S * gram(V)))
        loss = x_term + jax.lax.psum(
            penalty(U, hyper.alpha, hyper.l1_ratio), AXIS)
        loss = loss + penalty(V, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = loss + reconstruction_term(ops.Y, V, Z, cfg.y_link)
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _rows_aux_ok(cfg: SolverConfig, ops: _RowOperands, U) -> bool:
    """Rows-layout aux loss: MU always qualifies when U and V both update
    (the psummed V terms are computed regardless); Newton needs the
    chunked U-pass. x_link must be linear (the factored identity)."""
    from ..ops.links import LINEAR as _LIN

    from ..ops.chunked import is_chunked

    if not (cfg.update_U and cfg.update_V and cfg.x_link == _LIN):
        return False
    if ops.row_sq is None:
        return False
    if is_chunked(ops.X):
        return True  # the chunked step always emits the aux pair
    if not is_sparse(ops.X) and ops.X.dtype != U.dtype \
            and ops.X.size < (1 << 22):
        return False  # small mixed-precision: identity cancellation
    return True


def _rows_aux_ok_newton(cfg: SolverConfig, ops: _RowOperands, U) -> bool:
    """Newton needs the streamed chunked U-pass, whose accumulators are
    the aux pair, and a full batch."""
    from ..ops.chunked import is_chunked

    return (_rows_aux_ok(cfg, ops, U) and is_chunked(ops.X)
            and cfg.sg_sample_ratio >= 1.0)


def _aux_loss_rows_phi(cfg: SolverConfig):
    """Eval loss from V's accepted-candidate Σφ (solvers/newton.py φ-aux),
    rows layout: the iter already psummed the X side inside the line
    search, so the aux scalar is L_X + L_Y + R(V) exactly; add the sharded
    U's psummed penalty and the replicated Z's."""

    def loss_fn(state, aux, hyper: Hyper):
        ops, _, U, V, Z = state
        loss = aux + jax.lax.psum(
            penalty(U, hyper.alpha, hyper.l1_ratio), AXIS)
        if cfg.has_Y:
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _phi_zero(U, V, Z):
    return jnp.zeros((), U.dtype)


def _aux_fns_rows(cfg: SolverConfig, aux):
    if aux == "phi":
        return _aux_loss_rows_phi(cfg), _phi_zero
    return _aux_loss_rows(cfg), _aux_zero_pair


def _rows_aux_kind(cfg: SolverConfig, ops: _RowOperands, U, solver: str):
    """None | "factored" (linear X identity) | "phi" (sigmoid X: V's
    accepted-candidate Σφ — needs the V update, a real line search, and a
    full batch; mirrors solvers/newton._aux_kind)."""
    from ..ops.links import LINEAR as _LIN

    if solver == "mu" or cfg.x_link == _LIN:
        ok = (_rows_aux_ok(cfg, ops, U) if solver == "mu"
              else _rows_aux_ok_newton(cfg, ops, U))
        return "factored" if ok else None
    if not (cfg.update_V and cfg.line_search_trials >= 1
            and cfg.sg_sample_ratio >= 1.0):
        return None
    return "phi"


# ---------------------------------------------------------------------------
# MU blocks
# ---------------------------------------------------------------------------


def _rows_x_mm(ops: _RowOperands, B, transpose: bool = False):
    """X_loc @ B (or X_locᵀ @ B) for dense, CSR or chunked shards."""
    from ..ops.chunked import (chunked_spmm, chunked_spmm_t, is_chunked,
                               local_chunked)

    if is_chunked(ops.X):
        Xl = local_chunked(ops.X)
        return chunked_spmm_t(Xl, B) if transpose else chunked_spmm(Xl, B)
    if not is_sparse(ops.X):
        Xl = ops.X
        return matmul(Xl.T if transpose else Xl, B)
    return spmm(_local_csr(ops.Xt if transpose else ops.X), B)


def _mu_rows_iter(ops: _RowOperands, U, V, Z, mask, cfg, hyper,
                  with_aux: bool = False):
    """One MU iteration, rows layout. psums: XᵀU and UᵀU (shared-V terms).

    Chunked X takes the streamed single-X-pass U update per shard: its
    numV/gramU accumulators are exactly the quantities the layout psums.

    with_aux: also return the PSUMMED X-side V terms (ΣXᵀU_new, ΣU_newᵀU_new)
    — already reduced for the V update, they let the fit loop evaluate the
    loss with no extra pass over X and no extra collective (_aux_loss_rows).
    """
    from ..ops.chunked import is_chunked, local_chunked

    l1 = hyper.alpha * hyper.l1_ratio
    l2 = hyper.alpha * (1.0 - hyper.l1_ratio)
    eps = hyper.eps
    chunk = is_chunked(ops.X)

    num_vx = gram_u = None
    VtV = gram(V) if (cfg.update_U or (cfg.has_Y and cfg.update_Z)) else None
    if cfg.update_U:
        # Shard zero-padding rows must come out of the update as EXACT
        # zeros: the ratio gives 0·0/0 = NaN there when l1 = eps = 0, and
        # one NaN row poisons every psummed term (0·NaN = NaN).
        if chunk and cfg.update_V:
            # streamed single-X-pass per shard: the scan's accumulators
            # are exactly the shared-V terms the layout psums below
            from ..ops.chunked import chunked_mu_u_pass

            U, num_vx, gram_u = chunked_mu_u_pass(
                local_chunked(ops.X), U, V, VtV, l1, l2, eps,
                row_mask=mask)
        else:
            num = _rows_x_mm(ops, V)
            U = mu_ratio_update(U, VtV, num, l1, l2, eps)
            U = jnp.where(mask[:, None] > 0.5, U, 0.0)
    if cfg.has_Y and cfg.update_Z:
        if is_sparse(ops.Y):
            num = spmm(ops.Yt, V)
        else:
            num = matmul(ops.Y.T, V)
        Z = mu_ratio_update(Z, VtV, num, l1, l2, eps)
    aux = None
    if cfg.update_V:
        if num_vx is None:
            num_vx = _rows_x_mm(ops, U, transpose=True)
            gram_u = gram(U)
        num = jax.lax.psum(num_vx, AXIS)             # shared-V all-reduce
        S = jax.lax.psum(gram_u, AXIS)
        aux = (num, S)                               # X-side, pre-Y
        if cfg.has_Y:
            num = num + (spmm(ops.Y, Z) if is_sparse(ops.Y)
                         else matmul(ops.Y, Z))
            S = S + gram(Z)
        V = mu_ratio_update(V, S, num, l1, l2, eps)
    if with_aux:
        assert aux is not None, "with_aux requires update_V"
        return U, V, Z, aux
    return U, V, Z


def _cols_local_views(ops: _ColOperands):
    """Local (inside-shard_map) views of the cols operands: (Xl, Xtl).
    Dense Xtl is Xl.T; a chunked Xl carries NO transposed layout
    (chunked_spmm_t streams the forward chunks), so Xtl is None."""
    from ..ops.chunked import is_chunked, local_chunked

    if is_chunked(ops.X):
        return local_chunked(ops.X), None
    if is_sparse(ops.X):
        return _local_csr(ops.X), _local_csr(ops.Xt)
    return ops.X, ops.X.T


def _mu_cols_iter(ops: _ColOperands, U, V, Z, cfg, hyper,
                  with_aux: bool = False):
    """One MU iteration, cols layout: V/Y/Xᵀ sharded on m, U/Z replicated.
    psums: X·V and VᵀV (U's terms), YᵀV (Z's term).

    with_aux: also return the LOCAL X-side V terms (X_locᵀU_new,
    U_newᵀU_new) — V is sharded here, so the pair stays per-shard and
    the aux loss psums only the scalar inner product (_aux_loss_cols):
    zero extra passes over X at eval points."""
    from ..ops.chunked import chunked_spmm, chunked_spmm_t, is_chunked

    l1 = hyper.alpha * hyper.l1_ratio
    l2 = hyper.alpha * (1.0 - hyper.l1_ratio)
    eps = hyper.eps
    chunk = is_chunked(ops.X)
    sparse_x = is_sparse(ops.X)
    Xl, Xtl = _cols_local_views(ops)
    Yd = ops.Y

    VtV = (jax.lax.psum(gram(V), AXIS)
           if (cfg.update_U or (cfg.has_Y and cfg.update_Z)) else None)
    if cfg.update_U:
        if chunk:
            num = jax.lax.psum(chunked_spmm(Xl, V), AXIS)
        else:
            num = jax.lax.psum(
                spmm(Xl, V) if sparse_x else matmul(Xl, V), AXIS)
        U = mu_ratio_update(U, VtV, num, l1, l2, eps)
    if cfg.has_Y and cfg.update_Z:
        num = jax.lax.psum(matmul(Yd.T, V), AXIS)
        Z = mu_ratio_update(Z, VtV, num, l1, l2, eps)
    aux = None
    if cfg.update_V:
        if chunk:
            num = chunked_spmm_t(Xl, U)
        else:
            num = spmm(Xtl, U) if sparse_x else matmul(Xtl, U)
        S = gram(U)
        aux = (num, S)                               # X-side, pre-Y
        if cfg.has_Y:
            num = num + matmul(Yd, Z)
            S = S + gram(Z)
        V = mu_ratio_update(V, S, num, l1, l2, eps)
        # shard zero-padding rows are 0·0/0 = NaN when l1 = eps = 0 —
        # force them back to exact zeros before they enter any psum
        V = jnp.where(ops.mask[:, None] > 0.5, V, 0.0)
    if with_aux:
        assert aux is not None, "with_aux requires update_V"
        return U, V, Z, aux
    return U, V, Z


def _loss_cols(ops: _ColOperands, U, V, Z, cfg, hyper):
    from ..ops.chunked import chunked_inner, is_chunked

    mask = ops.mask
    Yd = ops.Y
    sparse_x = is_sparse(ops.X)
    Xl, Xtl = _cols_local_views(ops)
    # One psummed Gram serves both linear terms (x- and y-branch).
    need_gv = cfg.x_link == LINEAR or (cfg.has_Y and cfg.y_link == LINEAR)
    gV = jax.lax.psum(gram(V), AXIS) if need_gv else None
    if cfg.x_link == LINEAR:
        if is_chunked(ops.X):
            # ⟨X_loc, U V_locᵀ⟩ streamed over the forward chunks
            a_sq = Xl.sq_norm
            inner = chunked_inner(Xl, U, V)
        elif sparse_x:
            a_sq = Xl.sq_norm
            inner = jnp.sum(spmm(Xtl, U) * V)
        else:
            from ..ops.losses import streamed_inner

            a_sq = jnp.sum(ops.row_sq_t[0])   # exact fit-time norms
            # factor-precision inner (see _loss_rows), block-streamed
            inner = streamed_inner(Xtl, V, U)
        x_term = 0.5 * (jax.lax.psum(a_sq - 2.0 * inner, AXIS)
                        + jnp.sum(gram(U) * gV))
    elif is_chunked(ops.X):
        # streamed masked sigmoid residual over the local column block
        from ..ops.losses import _sigmoid_term

        x_term = jax.lax.psum(
            _sigmoid_term(Xl, U, V, None, col_mask=mask), AXIS)
    else:
        # X columns are sharded: elementwise sigmoid residual is local per
        # column block; padded columns masked out (σ(0)=0.5 ≠ 0).
        R = Xl - jax.nn.sigmoid(matmul(U, V.T))
        x_term = 0.5 * jax.lax.psum(jnp.sum(R * R * mask[None, :]), AXIS)
    loss = x_term + penalty(U, hyper.alpha, hyper.l1_ratio)
    loss = loss + jax.lax.psum(penalty(V, hyper.alpha, hyper.l1_ratio), AXIS)
    if cfg.has_Y:
        if is_chunked(Yd):
            # streamed chunked sigmoid-Y carrier (linear Y never chunks)
            from ..ops.chunked import local_chunked
            from ..ops.losses import _sigmoid_term

            y_term = jax.lax.psum(
                _sigmoid_term(local_chunked(Yd), V, Z, mask), AXIS)
        else:
            Yf = Yd.astype(V.dtype) if Yd.dtype != V.dtype else Yd
            if cfg.y_link == LINEAR:
                y_sq = jax.lax.psum(jnp.sum(Yf * Yf), AXIS)
                y_inner = jax.lax.psum(jnp.sum(matmul(Yf.T, V) * Z), AXIS)
                y_term = 0.5 * (y_sq - 2.0 * y_inner
                                + jnp.sum(gV * gram(Z)))
            else:
                R = Yf - jax.nn.sigmoid(matmul(V, Z.T))
                y_term = 0.5 * jax.lax.psum(
                    jnp.sum(mask[:, None] * R * R), AXIS)
        loss = loss + y_term + penalty(Z, hyper.alpha, hyper.l1_ratio)
    return loss


def _cols_local_asq(ops: _ColOperands):
    """This shard's ‖X_loc‖² (fit-time constant; completed by a psum)."""
    from ..ops.chunked import is_chunked, local_chunked

    if is_chunked(ops.X):
        return local_chunked(ops.X).sq_norm
    if is_sparse(ops.X):
        return _local_csr(ops.X).sq_norm
    return jnp.sum(ops.row_sq_t[0])


def _aux_loss_cols(cfg: SolverConfig, ops: _ColOperands):
    """Loss from the step's LOCAL X-side V terms — no pass over X.

    Mirrors _aux_loss_rows for the cols layout: here V is sharded, so the
    aux pair (X_locᵀU, UᵀU) stays per-shard and only the scalar inner
    product, ‖X‖², and the k×k Gram reduce over the mesh axis (the same
    collectives _loss_cols already pays — minus its full X pass)."""

    def loss_fn(state, aux, hyper: Hyper):
        _, __, U, V, Z = state
        num, S = aux
        a_sq = jax.lax.psum(_cols_local_asq(ops), AXIS)
        inner = jax.lax.psum(jnp.sum(num * V), AXIS)
        gV = jax.lax.psum(gram(V), AXIS)
        x_term = 0.5 * (a_sq - 2.0 * inner + jnp.sum(S * gV))
        loss = x_term + penalty(U, hyper.alpha, hyper.l1_ratio)
        loss = loss + jax.lax.psum(
            penalty(V, hyper.alpha, hyper.l1_ratio), AXIS)
        if cfg.has_Y:
            from ..ops.chunked import is_chunked as _ick

            Yd = ops.Y
            if _ick(Yd):
                # streamed chunked sigmoid-Y carrier (factored x-aux
                # stays valid — the Y term just streams its chunks)
                from ..ops.chunked import local_chunked
                from ..ops.losses import _sigmoid_term

                y_term = jax.lax.psum(
                    _sigmoid_term(local_chunked(Yd), V, Z, ops.mask),
                    AXIS)
            else:
                Yf = Yd.astype(V.dtype) if Yd.dtype != V.dtype else Yd
                if cfg.y_link == LINEAR:
                    y_sq = jax.lax.psum(jnp.sum(Yf * Yf), AXIS)
                    y_inner = jax.lax.psum(
                        jnp.sum(matmul(Yf.T, V) * Z), AXIS)
                    y_term = 0.5 * (y_sq - 2.0 * y_inner
                                    + jnp.sum(gV * gram(Z)))
                else:
                    R = Yf - jax.nn.sigmoid(matmul(V, Z.T))
                    y_term = 0.5 * jax.lax.psum(
                        jnp.sum(ops.mask[:, None] * R * R), AXIS)
            loss = loss + y_term + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _cols_aux_ok(cfg: SolverConfig, ops: _ColOperands, V) -> bool:
    """Cols-layout aux loss qualifies under the same rules as the rows
    layout: both U and V updating (the V step computes the pair either
    way), linear x_link (the factored identity), and no small
    mixed-precision dense X (identity cancellation at data precision)."""
    from ..ops.chunked import is_chunked

    if not (cfg.update_U and cfg.update_V and cfg.x_link == LINEAR):
        return False
    if is_chunked(ops.X) or is_sparse(ops.X):
        return True
    if ops.row_sq_t is None:
        return False
    if ops.X.dtype != V.dtype and ops.X.size < (1 << 22):
        return False
    return True


def _cols_aux_ok_newton(cfg: SolverConfig, ops: _ColOperands, V) -> bool:
    """Newton cols aux additionally needs the full-batch V update (a
    sampled term's DB/BtB describe the subsample) through the generic
    newton_update_factor path — which every linear-x V update takes."""
    return (_cols_aux_ok(cfg, ops, V) and cfg.sg_sample_ratio >= 1.0
            and cfg.hessian_form == "gauss")


def _aux_loss_cols_phi(cfg: SolverConfig):
    """φ-aux eval loss, cols layout: the iter masked the padding V rows
    and psummed the per-shard Σφ (V's rows partition m), so the aux is
    L_X + L_Y + R(V) exactly; U and Z are replicated — add their
    penalties once."""

    def loss_fn(state, aux, hyper: Hyper):
        _, __, U, V, Z = state
        loss = aux + penalty(U, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_fns_cols(cfg: SolverConfig, ops, aux):
    if aux == "phi":
        return _aux_loss_cols_phi(cfg), _phi_zero
    return _aux_loss_cols(cfg, ops), _aux_zero_pair


def _cols_aux_kind(cfg: SolverConfig, ops: _ColOperands, V, solver: str):
    """None | "factored" | "phi" — the cols-layout mirror of
    _rows_aux_kind (see solvers/newton._aux_kind for the φ-aux rules)."""
    if solver == "mu" or cfg.x_link == LINEAR:
        ok = (_cols_aux_ok(cfg, ops, V) if solver == "mu"
              else _cols_aux_ok_newton(cfg, ops, V))
        return "factored" if ok else None
    if not (cfg.update_V and cfg.line_search_trials >= 1
            and cfg.sg_sample_ratio >= 1.0):
        return None
    return "phi"


# ---------------------------------------------------------------------------
# Newton block (rows layout)
# ---------------------------------------------------------------------------


def _newton_rows_iter(ops: _RowOperands, U, V, Z, mask, cfg, hyper, rng,
                      with_aux: bool = False):
    """One Newton iteration, rows layout: U local; Z replicated; V's X-side
    (g, H, φ) contributions psummed (BASELINE.json: "all-reduce of shared-V
    gradient/denominator terms" — here stacked per-row g/H).

    When the streamed chunked U-pass runs, its per-shard XᵀU_new /
    U_newᵀU_new are psummed ONCE and handed to the V update as
    already-reduced DB/BtB with a replicated global row-norm vector —
    which removes the per-line-search-trial (m,) φ psums entirely (one
    (m,k) all-reduce replaces ~9 (m,) ones). with_aux additionally returns
    the reduced pair for the fit loop's zero-extra-pass loss eval.
    """
    kU, kZ, kV = jax.random.split(rng, 3)
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio)
    from ..ops.chunked import is_chunked, local_chunked
    from ..solvers.newton import Term

    chunk = is_chunked(ops.X)
    sparse_x = is_sparse(ops.X)
    Xl = (local_chunked(ops.X) if chunk
          else _local_csr(ops.X) if sparse_x else ops.X)

    chunk_full = chunk and cfg.sg_sample_ratio >= 1.0
    chunk_ok = chunk_full and cfg.x_link == LINEAR
    chunk_sig = chunk_full and cfg.x_link != LINEAR
    # the accumulator-emitting streamed pass only pays off when the V
    # update consumes XᵀU_new/UᵀU; U-only fold-ins take the generic
    # Term path (one streamed DB pass, no accumulators)
    chunk_pass = chunk_ok and cfg.update_V
    numv_x = gram_u = None
    if cfg.update_U:
        # Sampled chunked X (sg_sample_ratio < 1) falls through to the
        # generic newton_update_factor branch below: the per-shard draw
        # (kU folded by the axis index) enters the streamed terms as a
        # column mask (solvers/newton.sample_mask — masked sums == the
        # dense path's gathered sums exactly), so the trajectory matches
        # the dense sampled sharded fit.
        if chunk_sig:
            # row-local streamed sigmoid update per shard (one scatter
            # pass, line search in-chunk); the shard's zero-padding rows
            # fold into the chunk scan's own row mask
            from ..solvers.newton_chunked import chunked_sigmoid_row_update

            U = chunked_sigmoid_row_update(
                Xl, U, V, hyper, trials=cfg.line_search_trials,
                non_negative=cfg.U_non_negative,
                hessian_form=cfg.hessian_form, row_mask=mask)
        elif chunk_pass:
            # Streamed per-shard single-X-pass (ops/chunked.py): Newton
            # row updates are row-local, and the pass's XᵀU_new /
            # U_newᵀU_new accumulators are exactly the shared-V
            # contributions this layout psums below.
            from ..ops.chunked import chunked_newton_linear_u_pass
            from ..solvers.newton import shared_gauss_hinv

            BtB, Hinv, l1, l2 = shared_gauss_hinv(V, hyper)
            U, numv_x, gram_u = chunked_newton_linear_u_pass(
                Xl, U, V, BtB, Hinv, ops.row_sq, l1, l2,
                trials=cfg.line_search_trials,
                non_negative=cfg.U_non_negative)
        else:
            # Local rows — no communication. Per-shard sample keys.
            kU = jax.random.fold_in(kU, jax.lax.axis_index(AXIS))
            U = newton_update_factor(
                kU, U, (Term(Xl, V, ops.row_sq),), (cfg.x_link,),
                hyper, non_negative=cfg.U_non_negative, **common)
        U = U * mask[:, None]   # keep padding rows exactly zero
    if cfg.has_Y and cfg.update_Z:
        from ..ops.chunked import ChunkedT, is_chunked as _ick

        # Y is replicated in this layout — every shard runs the same local
        # update (mirrors the single-device Z branch). Chunked Y (the
        # replicated streamed sigmoid carrier) is consumed in the
        # transposed orientation.
        Yt = (ChunkedT(ops.Y) if _ick(ops.Y)
              else ops.Yt if is_sparse(ops.Y) else ops.Y.T)
        Z = newton_update_factor(
            kZ, Z, ((Yt, V),), (cfg.y_link,), hyper,
            non_negative=cfg.Z_non_negative, **common)
    aux = None
    if cfg.update_V:
        # chunked: Xl itself is the placeholder D (every V-term below
        # supplies DB/BtB, so D is never read for linear links)
        Xtl = (Xl if chunk
               else _local_csr(ops.Xt) if sparse_x else Xl.T)
        if numv_x is not None:
            # Reduce the U-pass accumulators ONCE; the V update then sees
            # an already-global X-side term (dist=False) with the
            # replicated global row norms — no per-φ-trial psums.
            num_glob = jax.lax.psum(numv_x, AXIS)
            gram_glob = jax.lax.psum(gram_u, AXIS)
            aux = (num_glob, gram_glob)
            terms = (Term(Xtl, U, ops.row_sq_t_glob,
                          DB=num_glob, BtB=gram_glob),)
            dist = (False,)
        elif chunk_sig or (chunk and cfg.sg_sample_ratio < 1.0):
            # streamed X-term in the TRANSPOSED orientation (ChunkedT):
            # sigmoid (G, H_rows, φ) partials accumulate over the forward
            # chunks; a sampled linear term recomputes its masked DB/BtB/
            # col norms through the same marker (newton_update_factor's
            # per-shard sample mask — gathered == masked sums exactly).
            # Either way the partials psum over the row shards.
            from ..ops.chunked import ChunkedT

            terms = (Term(ChunkedT(Xl), U,
                          ops.row_sq_t[0] if cfg.x_link == LINEAR
                          else None),)
            dist = (True,)
        elif chunk:
            # V-only update (e.g. frozen-U fits) on chunked X: the local
            # Xᵀ U and UᵀU partials feed the distributed machinery
            from ..ops.chunked import chunked_spmm_t

            terms = (Term(Xtl, U, ops.row_sq_t[0],
                          DB=chunked_spmm_t(Xl, U), BtB=gram(U)),)
            dist = (True,)
        else:
            terms = (Term(Xtl, U, ops.row_sq_t[0]),)
            dist = (True,)
        links = (cfg.x_link,)
        masks = (mask if cfg.x_link != LINEAR else None,)
        if cfg.has_Y:
            terms = terms + ((ops.Y, Z),)
            links = links + (cfg.y_link,)
            dist = dist + (False,)
            masks = masks + (None,)
        out = newton_update_factor(
            kV, V, terms, links, hyper,
            non_negative=cfg.V_non_negative, distributed=dist,
            masks=masks, axis_name=AXIS,
            return_phi=with_aux == "phi", **common)
        if with_aux == "phi":
            # V is replicated here — its per-row φ (X side psummed
            # inside, Y side replicated) sums to the full objective
            V, phi_rows = out
            aux = jnp.sum(phi_rows)
        else:
            V = out
    if with_aux:
        assert aux is not None, \
            ("phi-aux requires update_V" if with_aux == "phi" else
             "with_aux requires the chunked U-pass and update_V")
        return U, V, Z, aux
    return U, V, Z


def _newton_cols_iter(ops: _ColOperands, U, V, Z, cfg, hyper, rng,
                      with_aux: bool = False):
    """One Newton iteration, cols layout: the shared dimension m is sharded,
    so V's update is fully LOCAL (its rows see local X columns and local Y
    rows) while U's and Z's (g, H, φ) contributions are psummed — the
    mirror image of the rows layout. Sparse X terms use fit-time row
    norms (ops.row_sq partial per shard — completed by the φ psum).

    with_aux: also return the LOCAL X-side pair (X_locᵀU_new, U_newᵀU_new)
    — the V update's linear-term (DB, BtB), already computed inside
    newton_update_factor (term_cache) — for the zero-extra-pass eval loss
    (_aux_loss_cols). Requires _cols_aux_ok_newton (linear full-batch X
    term through the generic V update)."""
    from ..solvers.newton import Term

    kU, kZ, kV = jax.random.split(rng, 3)
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio)
    mask = ops.mask
    from ..ops.chunked import ChunkedT, chunked_spmm_t, is_chunked
    from ..ops.chunked import local_chunked

    # chunked sigmoid-Y carrier: Y's rows are the sharded m axis here, so
    # each shard streams its LOCAL row slice — Z via the transposed
    # orientation below, V's Y-term forward
    y_chunk = is_chunked(ops.Y)
    Yd = local_chunked(ops.Y) if y_chunk else ops.Y
    Xl, Xtl = _cols_local_views(ops)
    xmask = mask if cfg.x_link != LINEAR else None
    ymask = mask if cfg.y_link != LINEAR else None
    rsq = None if ops.row_sq is None else ops.row_sq[0]
    rsq_t = None if ops.row_sq_t is None else ops.row_sq_t[0]

    if cfg.update_U:
        U = newton_update_factor(
            kU, U, (Term(Xl, V, rsq),), (cfg.x_link,), hyper,
            non_negative=cfg.U_non_negative, distributed=(True,),
            masks=(xmask,), axis_name=AXIS, **common)
    if cfg.has_Y and cfg.update_Z:
        Yt = ChunkedT(Yd) if y_chunk else Yd.T
        Z = newton_update_factor(
            kZ, Z, ((Yt, V),), (cfg.y_link,), hyper,
            non_negative=cfg.Z_non_negative, distributed=(True,),
            masks=(ymask,), axis_name=AXIS, **common)
    aux = None
    if cfg.update_V:
        chunk = is_chunked(Xl)
        kV = jax.random.fold_in(kV, jax.lax.axis_index(AXIS))
        if chunk and cfg.x_link == LINEAR and cfg.sg_sample_ratio >= 1.0:
            # linear-link V term is fully local here (its rows see
            # whole X columns): Xᵀ U streams over the forward chunks,
            # and D is never read once DB/BtB/row_sq are supplied
            terms = (Term(Xl, U, rsq_t,
                          DB=chunked_spmm_t(Xl, U), BtB=gram(U)),)
        elif chunk and cfg.x_link == LINEAR:
            # sampled linear term: the transposed-orientation marker
            # lets newton_update_factor recompute the masked DB/BtB/
            # col norms under its per-shard draw (kV is axis-folded
            # above, so shards sample independently, exactly like the
            # dense cols path)
            terms = (Term(ChunkedT(Xl), U, rsq_t),)
        elif chunk:
            # sigmoid V term streamed over the forward chunks
            # (transposed orientation — the ChunkedT marker); fully
            # local too, so no psums and no column mask (padding V
            # rows are re-zeroed below)
            terms = (Term(ChunkedT(Xl), U),)
        else:
            terms = (Term(Xtl, U, rsq_t),)
        links = (cfg.x_link,)
        if cfg.has_Y:
            terms = terms + ((Yd, Z),)
            links = links + (cfg.y_link,)
        phi_aux = with_aux == "phi"
        out = newton_update_factor(
            kV, V, terms, links, hyper,
            non_negative=cfg.V_non_negative,
            term_cache=0 if (with_aux and not phi_aux) else None,
            return_phi=phi_aux, **common)
        if phi_aux:
            # the update is fully local here — mask the padding V
            # rows' φ, then psum the partial sums over the m shards
            V, phi_rows = out
            aux = jax.lax.psum(jnp.sum(phi_rows * mask), AXIS)
        elif with_aux:
            V, aux = out
        else:
            V = out
        V = V * mask[:, None]   # keep padding rows exactly zero
    if with_aux:
        assert aux is not None, \
            ("phi-aux requires update_V" if with_aux == "phi" else
             "with_aux requires _cols_aux_ok_newton (linear full-batch "
             "X term through the generic V update)")
        return U, V, Z, aux
    return U, V, Z


# ---------------------------------------------------------------------------
# Device-resident sharded fits: the entire tol loop runs inside shard_map —
# every device executes the while_loop in lockstep (synchronized by the
# psums in the per-iteration functions), so a multi-chip fit costs ONE
# dispatch instead of one per eval block.
# ---------------------------------------------------------------------------


def _make_rows_device_fit(cfg: SolverConfig, mesh, solver: str, ops_specs,
                          aux: bool = False):
    from ..solvers.common import device_fit_core

    def step_fn(ops, _, U, V, Z, hyper, key=None):
        if solver == "mu":
            return _mu_rows_iter(ops, U, V, Z, ops.mask, cfg, hyper,
                                 with_aux=aux)
        return _newton_rows_iter(ops, U, V, Z, ops.mask, cfg, hyper, key,
                                 with_aux=aux)

    def loss_core(state, hyper):
        ops, _, U, V, Z = state
        return _loss_rows(ops, U, V, Z, ops.mask, cfg, hyper)

    aux_loss, aux_init = _aux_fns_rows(cfg, aux)
    core = device_fit_core(
        step_fn, loss_core, carry_rng=(solver != "mu"),
        aux_loss=aux_loss if aux else None,
        aux_init=aux_init if aux else None)
    in_specs = (ops_specs, P(AXIS, None), P(), P(), P(), P(), P())
    out_specs = (P(AXIS, None), P(), P(), P(), P())

    @partial(jax.jit, static_argnames=("max_iter", "eval_every"))
    def fit(ops, U, V, Z, hyper, rng, tol, max_iter, eval_every):
        sm = jax.shard_map(
            lambda ops, U, V, Z, hyper, rng, tol: core(
                ops, None, U, V, Z, hyper, rng, tol, max_iter, eval_every),
            mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False)
        return sm(ops, U, V, Z, hyper, rng, tol)

    return fit


def _make_cols_device_fit(cfg: SolverConfig, mesh, solver: str, ops_specs,
                          aux: bool = False):
    from ..solvers.common import device_fit_core

    def make_core(ops):
        def step_fn(_, __, U, V, Z, hyper, key=None):
            if solver == "mu":
                return _mu_cols_iter(ops, U, V, Z, cfg, hyper,
                                     with_aux=aux)
            return _newton_cols_iter(ops, U, V, Z, cfg, hyper, key,
                                     with_aux=aux)

        def loss_core(state, hyper):
            _, __, U, V, Z = state
            return _loss_cols(ops, U, V, Z, cfg, hyper)

        aux_loss, aux_init = _aux_fns_cols(cfg, ops, aux)
        return device_fit_core(
            step_fn, loss_core, carry_rng=(solver != "mu"),
            aux_loss=aux_loss if aux else None,
            aux_init=aux_init if aux else None)

    in_specs = (ops_specs, P(), P(AXIS, None), P(), P(), P(), P())
    out_specs = (P(), P(AXIS, None), P(), P(), P())

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


# ---------------------------------------------------------------------------
# Block factories + host runner
# ---------------------------------------------------------------------------


def _shard_specs_rows(ops: _RowOperands):
    from ..ops.chunked import is_chunked

    x_spec = (P(AXIS) if is_sparse(ops.X) or is_chunked(ops.X)
              else P(AXIS, None))
    xt_spec = None if ops.Xt is None else P(AXIS)
    y_spec = None if ops.Y is None else P()
    yt_spec = None if ops.Yt is None else P()
    return _RowOperands(x_spec, xt_spec, y_spec, yt_spec, P(AXIS),
                        P(AXIS), P(AXIS), P())


def _make_rows_block(cfg: SolverConfig, mesh, solver: str, ops_specs,
                     aux: bool = False):
    in_specs = (ops_specs, P(AXIS, None), P(), P(), P(), P())
    out_specs = ((P(AXIS, None), P(), P()), P(), P())

    def body(ops, U, V, Z, hyper, rng, n_steps):
        # rng = (key, absolute iteration offset) — same fold_in schedule as
        # device_fit_core, so host- and device-loop sharded fits match.
        mask = ops.mask
        key, off = rng

        aux_loss, aux_init = _aux_fns_rows(cfg, aux)

        def one(i, carry):
            U, V, Z, _a = carry
            k = jax.random.fold_in(key, off + i)
            if solver == "mu":
                out = _mu_rows_iter(ops, U, V, Z, mask, cfg, hyper,
                                    with_aux=aux)
            else:
                out = _newton_rows_iter(ops, U, V, Z, mask, cfg, hyper, k,
                                        with_aux=aux)
            return out if aux else out + (_a,)

        U, V, Z, a = jax.lax.fori_loop(
            0, n_steps, one, (U, V, Z, aux_init(U, V, Z)))
        if aux:
            loss = aux_loss((ops, None, U, V, Z), a, hyper)
        else:
            loss = _loss_rows(ops, U, V, Z, mask, cfg, hyper)
        return (U, V, Z), loss, (key, off + n_steps)

    @partial(jax.jit, static_argnames=("n_steps",))
    def block(state, hyper, rng, n_steps):
        ops, U, V, Z = state
        sm = jax.shard_map(
            partial(body, n_steps=n_steps), mesh=mesh,
            in_specs=in_specs, out_specs=out_specs, check_vma=False)
        (U, V, Z), loss, rng = sm(ops, U, V, Z, hyper, rng)
        return (ops, U, V, Z), loss, rng

    def loss_fn(state, hyper):
        ops, U, V, Z = state
        sm = jax.shard_map(
            lambda ops, U, V, Z, h: _loss_rows(ops, U, V, Z, ops.mask, cfg,
                                               h),
            mesh=mesh, in_specs=in_specs[:4] + (P(),), out_specs=P(),
            check_vma=False)
        return sm(ops, U, V, Z, hyper)

    return block, jax.jit(loss_fn)


def _shard_specs_cols(ops: _ColOperands):
    from ..ops.chunked import is_chunked

    x_spec = (P(AXIS) if is_sparse(ops.X) or is_chunked(ops.X)
              else P(None, AXIS))
    xt_spec = None if ops.Xt is None else P(AXIS)
    y_spec = (None if ops.Y is None
              else P(AXIS) if is_chunked(ops.Y) else P(AXIS, None))
    return _ColOperands(x_spec, xt_spec, y_spec, P(AXIS), P(AXIS), P(AXIS))


def _make_cols_block(cfg: SolverConfig, mesh, solver: str, ops_specs,
                     aux: bool = False):
    in_specs = (ops_specs, P(), P(AXIS, None), P(), P(), P())
    out_specs = ((P(), P(AXIS, None), P()), P(), P())

    def body(ops, U, V, Z, hyper, rng, n_steps):
        key, off = rng
        aux_loss, aux_init = _aux_fns_cols(cfg, ops, aux)

        def one(i, carry):
            U, V, Z, _a = carry
            if solver == "mu":
                out = _mu_cols_iter(ops, U, V, Z, cfg, hyper,
                                    with_aux=aux)
            else:
                out = _newton_cols_iter(ops, U, V, Z, cfg, hyper,
                                        jax.random.fold_in(key, off + i),
                                        with_aux=aux)
            return out if aux else out + (_a,)

        U, V, Z, a = jax.lax.fori_loop(
            0, n_steps, one, (U, V, Z, aux_init(U, V, Z)))
        if aux:
            loss = aux_loss((ops, None, U, V, Z), a, hyper)
        else:
            loss = _loss_cols(ops, U, V, Z, cfg, hyper)
        return (U, V, Z), loss, (key, off + n_steps)

    @partial(jax.jit, static_argnames=("n_steps",))
    def block(state, hyper, rng, n_steps):
        ops, U, V, Z = state
        sm = jax.shard_map(
            partial(body, n_steps=n_steps), mesh=mesh,
            in_specs=in_specs, out_specs=out_specs, check_vma=False)
        (U, V, Z), loss, rng = sm(ops, U, V, Z, hyper, rng)
        return (ops, U, V, Z), loss, rng

    def loss_fn(state, hyper):
        ops, U, V, Z = state
        sm = jax.shard_map(
            lambda ops, U, V, Z, h: _loss_cols(ops, U, V, Z, cfg, h),
            mesh=mesh, in_specs=in_specs[:5], out_specs=P(),
            check_vma=False)
        return sm(ops, U, V, Z, hyper)

    return block, jax.jit(loss_fn)


def run_sharded(solver: str, X, Y, U0, V0, Z0, cfg: SolverConfig,
                hyper: Hyper, rng, *, n_shards: int, layout: str = "rows",
                dtype=jnp.float32, mesh=None, max_iter: int = 200,
                tol: float = 1e-4, eval_every: int = 10, verbose: int = 0,
                loop: str = "host", sparse_mode: str = "auto",
                data_dtype=None):
    """Sharded fit driver. X/Y are host matrices (ndarray or scipy.sparse);
    U0/V0/Z0 host ndarrays. Returns the same tuple as run_mu/run_newton.
    loop='device' runs the whole tol loop inside shard_map (one dispatch).

    sparse_mode='auto' densifies a sparse X when each device's LOCAL
    shard fits the densify threshold, and streams per-shard chunked-COO
    above it. 'csr' keeps per-shard segment-sum CSR; 'chunked' forces the
    streamed layout.
    """
    import time as _time

    from ..solvers.common import amortize_step_times, finish_device_fit

    if mesh is None:
        mesh = make_mesh(n_shards)
    d = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    k = U0.shape[1]

    if sp.issparse(X) and sparse_mode not in ("csr", "chunked"):
        from ..utils.validation import DENSIFY_THRESHOLD

        n, m = X.shape
        local = (-(-n // d)) * m if layout == "rows" else n * (-(-m // d))
        # per-shard device bytes at the storage dtype — fp8 shards really are
        # 1 byte/elt (the host densifies in f64 and uploads converted
        # shards; no on-device f32 scatter detour like as_coupled's)
        item = (jnp.dtype(data_dtype).itemsize if data_dtype is not None
                else jnp.dtype(dtype).itemsize)
        if sparse_mode == "dense" or local * item <= DENSIFY_THRESHOLD:
            # NB single-controller: the HOST materializes the full dense
            # matrix while splitting; each device holds only its shard.
            X = np.asarray(X.todense())

    if data_dtype is not None and data_dtype in FP8_DTYPES:
        # fp8 is a dense-storage format only — same rule as
        # as_coupled (CSR segment ops / chunked streaming have no fp8
        # promotion path). The estimator pre-checks this; direct callers
        # get the same clean error here.
        if sp.issparse(X):
            raise ValueError(
                "fp8 data storage requires dense device shards, but X "
                f"stays sparse under sparse_mode={sparse_mode!r} at this "
                "shard size; use data_dtype='bfloat16' or more shards")
        from ..utils.validation import check_fp8_range

        check_fp8_range(X, data_dtype)

    if layout == "rows":
        chunked = ("force" if sparse_mode == "chunked"
                   else "auto" if sparse_mode == "auto" else "never")
        ops, U_pad, n = _prepare_rows(X, Y, U0, d, dtype,
                                      data_dtype=data_dtype,
                                      chunked=chunked,
                                      y_link=cfg.y_link)
        V = jnp.asarray(V0, dtype=dtype)
        Z = (jnp.asarray(Z0, dtype=dtype) if Z0 is not None and cfg.has_Y
             else jnp.zeros((0, k), dtype=dtype))
        specs = _shard_specs_rows(ops)
        ops = place_operands(ops, specs, mesh)
        aux = _rows_aux_kind(cfg, ops, U_pad, solver)
        if loop == "device":
            fitf = _make_rows_device_fit(cfg, mesh, solver, specs, aux)
            t0 = _time.perf_counter()
            out = fitf(ops, U_pad, V, Z, hyper, rng,
                       jnp.asarray(tol, dtype), max_iter, eval_every)
            U, V, Z, n_iter, losses, iters = finish_device_fit(
                out, eval_every, max_iter)
            return (U[:n], V, Z, n_iter, losses, iters,
                    amortize_step_times(_time.perf_counter() - t0, iters))
        block, loss_fn = _make_rows_block(cfg, mesh, solver, specs, aux)
        state = (ops, U_pad, V, Z)
        state, n_iter, losses, iters, times = run_solver_loop(
            block, state, hyper, (rng, jnp.zeros((), jnp.int32)),
            max_iter=max_iter, tol=tol, eval_every=eval_every,
            verbose=verbose, initial_loss_fn=loss_fn)
        _, U, V, Z = state
        return U[:n], V, Z, n_iter, losses, iters, times

    if layout == "cols":
        chunked = ("force" if sparse_mode == "chunked"
                   else "auto" if sparse_mode == "auto" else "never")
        ops, V_pad, m = _prepare_cols(X, Y, V0, d, dtype,
                                      data_dtype=data_dtype,
                                      chunked=chunked,
                                      y_link=cfg.y_link)
        U = jnp.asarray(U0, dtype=dtype)
        Z = (jnp.asarray(Z0, dtype=dtype) if Z0 is not None and cfg.has_Y
             else jnp.zeros((0, k), dtype=dtype))
        specs = _shard_specs_cols(ops)
        ops = place_operands(ops, specs, mesh)
        aux = _cols_aux_kind(cfg, ops, V_pad, solver)
        if loop == "device":
            fitf = _make_cols_device_fit(cfg, mesh, solver, specs, aux)
            t0 = _time.perf_counter()
            out = fitf(ops, U, V_pad, Z, hyper, rng,
                       jnp.asarray(tol, dtype), max_iter, eval_every)
            U, V, Z, n_iter, losses, iters = finish_device_fit(
                out, eval_every, max_iter)
            return (U, V[:m], Z, n_iter, losses, iters,
                    amortize_step_times(_time.perf_counter() - t0, iters))
        block, loss_fn = _make_cols_block(cfg, mesh, solver, specs, aux)
        state = (ops, U, V_pad, Z)
        state, n_iter, losses, iters, times = run_solver_loop(
            block, state, hyper, (rng, jnp.zeros((), jnp.int32)),
            max_iter=max_iter, tol=tol, eval_every=eval_every,
            verbose=verbose, initial_loss_fn=loss_fn)
        _, U, V, Z = state
        return U, V[:m], Z, n_iter, losses, iters, times

    raise ValueError(f"layout must be 'rows' or 'cols', got {layout!r}")
