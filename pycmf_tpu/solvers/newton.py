"""Batched row-wise Newton solver.

The reference's Newton solver iterates rows in Python/numba
(SURVEY.md §3.1: "per iteration, per factor, per row"). Here that
serialization is removed: all rows of a factor are updated at once —
gradients and k×k Gauss-Newton Hessians are built with batched
matmuls/einsums, the stacked k×k systems are solved in one batched
Cholesky (or LU when they may be indefinite), and the backtracking line
search runs as a fixed number of masked trials evaluated for every row in
parallel (BASELINE.json north_star: "batched per-row Hessian build, solve,
and line search").

Per-row math (SURVEY.md §0 "Newton update", binding):

    p  = f(B mᵢ)
    g  = Bᵀ[(p − dᵢ) ⊙ f'(B mᵢ)] + l1·sign(mᵢ) + l2·mᵢ
    H  = Bᵀ diag(w) B + (l2 + hessian_pertubation)·I
         w = f'(⋅)²               (hessian_form='gauss')
         w = f'(⋅)² + (p−dᵢ)⊙f''  (hessian_form='full')
    mᵢ ← proj≥0( mᵢ − step · H⁻¹ g ),  step from backtracking line search

Every factor update is an instance of one generic routine over "terms"
(D, B, link): U sees one term (X, V); Z sees (Yᵀ, V); the shared V sees two
— (Xᵀ, U) and (Y, Z) — which is the coupling. Under the sharded runner the
X-side term's (G, H, φ) contributions are psummed over the mesh axis
(SURVEY.md §5 "Distributed communication backend").

Sampling: ``sg_sample_ratio`` subsamples the columns entering g, H and the
line-search objective each iteration (fixed sample size → static shapes;
SURVEY.md §0 note c). No rescaling is applied — g and H scale together, so
the Newton direction is unchanged in expectation (pinned assumption).

Sparse (CSR) data is supported for linear-link terms without densifying
(SpMM numerators + factored per-row line-search objective). Sigmoid-link
terms operate on dense data: the accumulation materializes dense (p, q)
predictions σ(M Bᵀ) regardless, so CSR storage saves nothing — the estimator
densifies sparse sigmoid-linked inputs at fit time (models/cmf.py
``_matrix_sparse_mode``), or streams them in row chunks (newton_chunked.py).
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.links import LINEAR
from ..ops.losses import total_loss
from ..ops.matmul import gram, matmul
from ..ops.sparse import is_sparse, row_sq_norms, spmm
from .common import Coupled, Hyper, SolverConfig, run_solver_loop


class Term(NamedTuple):
    """One coupled data term of a factor update: D ≈ f(M Bᵀ) row-wise.

    row_sq : optional precomputed per-row ‖dᵢ‖² (fit-time constant)
    DB     : optional precomputed D @ B (p, k) — e.g. the XᵀU_new
             accumulator emitted by the streamed chunked U-pass, which
             saves the V update its own pass over the data
    BtB    : optional precomputed gram(B) (k, k), paired with DB
    """

    D: object
    B: object
    row_sq: object = None
    DB: object = None
    BtB: object = None


class _LinearCtx(NamedTuple):
    """Candidate-independent quantities for a linear-link term's line search:
    φᵢ(m) = ½(‖dᵢ‖² − 2⟨(DB)ᵢ, m⟩ + mᵀ(BᵀB)m)."""
    DB: jnp.ndarray       # (p, k)
    BtB: jnp.ndarray      # (k, k)
    row_sq: jnp.ndarray   # (p,)
    distributed: bool


class _SigmoidCtx(NamedTuple):
    D: jnp.ndarray        # (p, q) dense
    B: jnp.ndarray        # (q, k)
    mask: Optional[jnp.ndarray]  # (q,) column mask (sharded padding)
    distributed: bool


def _sample_columns(rng, D, B, mask, ratio: float):
    """Uniform without-replacement column subsample with a static size."""
    q = B.shape[0]
    s = max(1, int(-(-ratio * q // 1)))  # ceil, static
    if s >= q:
        return D, B, mask
    idx = jax.random.choice(rng, q, shape=(s,), replace=False)
    Ds = jnp.take(D, idx, axis=1)
    Bs = jnp.take(B, idx, axis=0)
    ms = None if mask is None else jnp.take(mask, idx, axis=0)
    return Ds, Bs, ms


def sample_mask(rng, q: int, ratio: float, dtype):
    """The SAME without-replacement draw as _sample_columns, as a (q,)
    0/1 mask (None when the draw would be the full set).

    Sampling = masking: ``sg_sample_ratio`` enters g, H and φ as plain
    sums over the drawn columns with NO rescaling (module docstring), so
    zeroing the complementary columns reproduces the gathered
    computation exactly — which is how CSR/chunked terms, whose columns
    cannot be gathered on device, run stochastic Newton: the mask folds
    into B (linear: B·mask, masked row norms) or into the prediction
    weights (sigmoid: the existing padding-mask machinery)."""
    s = max(1, int(-(-ratio * q // 1)))  # ceil, static
    if s >= q:
        return None
    idx = jax.random.choice(rng, q, shape=(s,), replace=False)
    return jnp.zeros((q,), dtype).at[idx].set(1)


def _accumulate_term(M, D, B, link: str, hessian_form: str, mask,
                     distributed: bool, row_sq=None, db=None, btb=None):
    """Return (G_term (p,k), H_shared (k,k) | None, H_rows (p,k,k) | None,
    line-search ctx) for one coupled term."""
    from ..ops.chunked import ChunkedT, chunked_spmm, is_chunked

    if link == LINEAR:
        if mask is not None:
            # Masked column subsample (sample_mask): fold the 0/1 mask
            # into B — zeroed rows drop out of BtB and DB exactly as
            # gathering the drawn columns would — and recompute the
            # line-search row norms under the same mask. This is how
            # CSR/chunked terms run stochastic Newton (their columns
            # cannot be gathered on device).
            from ..ops.chunked import (chunked_masked_col_sq,
                                       chunked_masked_row_sq,
                                       chunked_spmm_t)

            mv = mask.astype(M.dtype)
            Bm = B * mask[:, None].astype(B.dtype)
            BtB = gram(Bm)
            if isinstance(D, ChunkedT):
                DB = chunked_spmm_t(D.ck, Bm)
                row_sq = chunked_masked_col_sq(D.ck, mv)
            elif is_chunked(D):
                DB = chunked_spmm(D, Bm)
                row_sq = chunked_masked_row_sq(D, mv)
            elif is_sparse(D):
                from ..ops.sparse import masked_row_sq_norms

                DB = spmm(D, Bm)
                row_sq = masked_row_sq_norms(D, mv)
            else:
                DB = matmul(D, Bm)
                Df = D.astype(M.dtype) if D.dtype != M.dtype else D
                row_sq = jnp.matmul(Df * Df, mv,
                                    precision=jax.lax.Precision.HIGHEST)
            G = matmul(M, BtB) - DB
            return G, BtB, None, _LinearCtx(DB, BtB, row_sq, distributed)
        # Zero-padded B rows (sharding) contribute 0 to BtB/DB — no mask.
        BtB = gram(B) if btb is None else btb
        if db is not None:
            DB = db
        elif isinstance(D, ChunkedT):
            # transposed-orientation streamed term (V's X side, sampled-
            # invalidated caches): one Xᵀ·B accumulation pass
            from ..ops.chunked import chunked_spmm_t

            DB = chunked_spmm_t(D.ck, B)
        elif is_chunked(D):
            DB = chunked_spmm(D, B)   # streamed scatter+matmul pass
        elif is_sparse(D):
            DB = spmm(D, B)
        else:
            DB = matmul(D, B)
        G = matmul(M, BtB) - DB
        if row_sq is None:
            if is_chunked(D) or isinstance(D, ChunkedT):
                raise ValueError(
                    "chunked-COO Newton terms need precomputed row_sq "
                    "(per-nonzero norms are a fit-time constant — see "
                    "as_coupled)")
            if is_sparse(D):
                row_sq = row_sq_norms(D)
            else:
                Df = D.astype(M.dtype) if D.dtype != M.dtype else D
                row_sq = jnp.sum(Df * Df, axis=1)
        return G, BtB, None, _LinearCtx(DB, BtB, row_sq, distributed)

    from ..ops.chunked import ChunkedT

    if isinstance(D, ChunkedT):
        # Sigmoid term streamed over the forward chunks (V's X-side when
        # X is chunked — solvers/newton_chunked.py). A sharding column
        # mask folds into the chunk scan's own padding-row mask.
        from .newton_chunked import (ChunkedTSigCtx,
                                     chunked_sigmoid_colwise_terms)

        G, H_rows = chunked_sigmoid_colwise_terms(D.ck, M, B,
                                                  hessian_form,
                                                  col_mask=mask)
        return G, None, H_rows, ChunkedTSigCtx(D.ck, B, distributed,
                                               mask)
    if is_chunked(D):
        # Forward-orientation streamed sigmoid term: M's rows are X's
        # rows (the cols layout's U against a column-sharded chunked X).
        # G/H stream per chunk; φ streams one pass per candidate.
        from .newton_chunked import (ChunkedSigRowCtx,
                                     chunked_sigmoid_rowwise_terms)

        G, H_rows = chunked_sigmoid_rowwise_terms(D, M, B, hessian_form,
                                                  mask=mask)
        return G, None, H_rows, ChunkedSigRowCtx(D, B, mask, distributed)
    if is_sparse(D):
        # Unreachable through the estimator (sigmoid-linked inputs are
        # densified or streamed at fit time); direct solver callers must
        # use a chunked layout (forward or ChunkedT-wrapped).
        raise NotImplementedError(
            "Newton sigmoid-link terms need dense D or a chunked "
            "streaming layout (the update materializes sigmoid "
            "predictions per row block either way)")
    P = jax.nn.sigmoid(matmul(M, B.T))       # (p, q)
    R = P - D.astype(P.dtype)
    fp = P * (1.0 - P)
    W = fp * fp
    if hessian_form == "full":
        W = W + R * (fp * (1.0 - 2.0 * P))   # + (p−d)⊙f''
    Rfp = R * fp
    if mask is not None:
        Rfp = Rfp * mask[None, :]
        W = W * mask[None, :]
    G = matmul(Rfp, B)
    # H_rows[i] = Bᵀ diag(W_i) B — one batched einsum.
    H_rows = jnp.einsum("pq,qk,ql->pkl", W, B, B,
                        precision=jax.lax.Precision.HIGHEST)
    return G, None, H_rows, _SigmoidCtx(D, B, mask, distributed)


def _phi_term(Mc, ctx) -> jnp.ndarray:
    """Per-row residual objective ½‖dᵢ − f(B mᵢ)‖² for a candidate factor."""
    if isinstance(ctx, _LinearCtx):
        quad = jnp.sum(matmul(Mc, ctx.BtB) * Mc, axis=1)
        return 0.5 * (ctx.row_sq - 2.0 * jnp.sum(ctx.DB * Mc, axis=1) + quad)
    from .newton_chunked import ChunkedSigRowCtx, ChunkedTSigCtx

    if isinstance(ctx, ChunkedTSigCtx):
        from .newton_chunked import chunked_sigmoid_colwise_phi

        return chunked_sigmoid_colwise_phi(ctx, Mc)
    if isinstance(ctx, ChunkedSigRowCtx):
        from .newton_chunked import chunked_sigmoid_rowwise_phi

        return chunked_sigmoid_rowwise_phi(ctx, Mc)
    R = ctx.D.astype(Mc.dtype) - jax.nn.sigmoid(matmul(Mc, ctx.B.T))
    if ctx.mask is not None:
        return 0.5 * jnp.sum(R * R * ctx.mask[None, :], axis=1)
    return 0.5 * jnp.sum(R * R, axis=1)


def _solve_direction(H_shared, H_rows, G, spd: bool = True):
    """d = H⁻¹ g for all rows at once.

    spd: the per-row systems are guaranteed positive-definite (true for
    hessian_form='gauss', where W = f'² ≥ 0 so H ⪰ (l2+pert)·I), and are
    solved by batched Cholesky. With hessian_form='full' the curvature
    weights can be negative and H indefinite — an unpivoted Cholesky
    would produce NaN pivots — so those systems go through
    jnp.linalg.solve (pivoted LU).
    """
    if H_rows is None:
        # One shared SPD k×k system (all-linear links) — a single solve.
        c, low = jax.scipy.linalg.cho_factor(H_shared)
        return jax.scipy.linalg.cho_solve((c, low), G.T).T
    H = H_rows + H_shared[None, :, :]
    if spd:
        L = jnp.linalg.cholesky(H)
        return jax.scipy.linalg.cho_solve((L, True), G[..., None])[..., 0]
    return jnp.linalg.solve(H, G[..., None])[..., 0]


def newton_update_factor(rng, M, terms, links, hyper: Hyper, *,
                         non_negative: bool, trials: int, hessian_form: str,
                         sample_ratio: float, distributed=(), masks=(),
                         axis_name=None,
                         term_cache=None, return_phi: bool = False):
    """One batched Newton update of factor M against its coupled terms.

    terms: tuple of (D, B); links: matching static link names;
    distributed: matching bools — True marks terms whose columns are sharded
    over ``axis_name`` (their G/H/φ contributions are psummed);
    masks: matching optional (q,) column masks for sharded sigmoid padding.

    term_cache: optional term index — additionally return that LINEAR
    term's already-computed (DB, BtB) pair alongside the updated factor.
    The pair is independent of the factor's line-search outcome (DB = DᵀB
    and BtB = BᵀB use only the coupled operands), so callers can reuse it
    for a zero-extra-pass factored loss eval (the sharded layouts' aux
    loss). Only valid for full-batch linear terms (a sampled term's
    masked pair describes the subsample, not the data).

    return_phi: additionally return the PER-ROW φ(M_new) — the line
    search evaluated the accepted candidate's objective anyway, and when
    M is the LAST factor updated in a step (V, whose φ sums every data
    term plus its own penalty) Σφ IS the eval loss minus the other
    factors' penalties, making loss/tol checks free of extra data passes
    (the φ-aux; full-batch only — a sampled φ describes the subsample).
    Returned per-row so sharded callers can mask padding rows before
    summing/psumming (single-chip callers just sum).
    """
    p, k = M.shape
    dtype = M.dtype
    l1 = hyper.alpha * hyper.l1_ratio
    l2 = hyper.alpha * (1.0 - hyper.l1_ratio)

    if not distributed:
        distributed = (False,) * len(terms)
    if not masks:
        masks = (None,) * len(terms)

    G_local = l1 * jnp.sign(M) + l2 * M
    G_dist = jnp.zeros_like(M)
    eye = jnp.eye(k, dtype=dtype)
    H_shared_local = (l2 + hyper.hessian_pertubation) * eye
    H_shared_dist = jnp.zeros_like(eye)
    H_rows_local = None
    H_rows_dist = None
    ctxs = []

    for t, (term, link, dist, mask) in enumerate(
            zip(terms, links, distributed, masks)):
        term = term if isinstance(term, Term) else Term(*term)
        D, B, row_sq, db, btb = term
        if sample_ratio < 1.0:
            from ..ops.chunked import ChunkedT as _CkT
            from ..ops.chunked import is_chunked as _is_ck

            key = jax.random.fold_in(rng, t)
            if dist and axis_name is not None:
                key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
            if is_sparse(D) or _is_ck(D) or isinstance(D, _CkT):
                # Columns of on-device sparse/streamed layouts cannot be
                # gathered — the SAME draw enters as a mask instead
                # (sample_mask: gathered sums == masked sums exactly).
                q = D.ck.shape[0] if isinstance(D, _CkT) else D.shape[1]
                smask = sample_mask(key, q, sample_ratio, M.dtype)
                if smask is not None:
                    mask = smask if mask is None else mask * smask
                    row_sq = db = btb = None  # caches invalidated
            else:
                D, B, mask = _sample_columns(key, D, B, mask, sample_ratio)
                row_sq = db = btb = None
        G_t, H_sh_t, H_rw_t, ctx = _accumulate_term(
            M, D, B, link, hessian_form, mask, dist,
            row_sq=row_sq, db=db, btb=btb)
        if dist:
            G_dist = G_dist + G_t
            if H_sh_t is not None:
                H_shared_dist = H_shared_dist + H_sh_t
            if H_rw_t is not None:
                H_rows_dist = H_rw_t if H_rows_dist is None \
                    else H_rows_dist + H_rw_t
        else:
            G_local = G_local + G_t
            if H_sh_t is not None:
                H_shared_local = H_shared_local + H_sh_t
            if H_rw_t is not None:
                H_rows_local = H_rw_t if H_rows_local is None \
                    else H_rows_local + H_rw_t
        ctxs.append(ctx)

    any_dist = axis_name is not None and any(distributed)
    if any_dist:
        G_dist = jax.lax.psum(G_dist, axis_name)
        H_shared_dist = jax.lax.psum(H_shared_dist, axis_name)
        if H_rows_dist is not None:
            H_rows_dist = jax.lax.psum(H_rows_dist, axis_name)
    G = G_local + G_dist
    H_shared = H_shared_local + H_shared_dist
    H_rows = H_rows_local
    if H_rows_dist is not None:
        H_rows = H_rows_dist if H_rows is None else H_rows + H_rows_dist

    d = _solve_direction(H_shared, H_rows, G, spd=hessian_form == "gauss")

    def project(Mc):
        return jnp.maximum(Mc, 0.0) if non_negative else Mc

    def phi(Mc):
        out = l1 * jnp.sum(jnp.abs(Mc), axis=1) \
            + 0.5 * l2 * jnp.sum(Mc * Mc, axis=1)
        acc_dist = jnp.zeros((p,), dtype)
        for ctx in ctxs:
            term = _phi_term(Mc, ctx)
            if ctx.distributed:
                acc_dist = acc_dist + term
            else:
                out = out + term
        if any_dist:
            acc_dist = jax.lax.psum(acc_dist, axis_name)
        return out + acc_dist

    from ..ops.linesearch import backtracking_select

    if return_phi:
        assert term_cache is None, "return_phi and term_cache are exclusive"
        return backtracking_select(phi, project, M, d, trials,
                                   return_phi=True)
    M_new = backtracking_select(phi, project, M, d, trials)
    if term_cache is not None:
        ctx = ctxs[term_cache]
        assert isinstance(ctx, _LinearCtx), \
            "term_cache requires a linear term"
        return M_new, (ctx.DB, ctx.BtB)
    return M_new


def shared_gauss_hinv(V, hyper: Hyper):
    """(BtB, Hinv, l1, l2) for the shared linear-link Gauss-Newton
    system H = VᵀV + (l2 + hessian_pertubation)·I.

    The damping formula is parity-critical and feeds the streamed chunked
    U-pass on one device AND in the sharded rows layout — built in exactly
    one place so the trajectories cannot desynchronize."""
    k = V.shape[1]
    l1 = hyper.alpha * hyper.l1_ratio
    l2 = hyper.alpha * (1.0 - hyper.l1_ratio)
    BtB = gram(V)
    eye = jnp.eye(k, dtype=V.dtype)
    H = BtB + (l2 + hyper.hessian_pertubation) * eye
    c, low = jax.scipy.linalg.cho_factor(H)
    return BtB, jax.scipy.linalg.cho_solve((c, low), eye), l1, l2


@lru_cache(maxsize=None)
def make_newton_step(cfg: SolverConfig, with_aux=False):
    """Pure jitted Newton step: update U, then Z, then V (pinned order).

    with_aux: zero-extra-pass loss machinery for the fit loops' eval/tol
    checks. True or "factored": additionally return (XᵀU_new, U_newᵀU_new)
    from the streamed chunked U-pass (linear X link; see _aux_loss). "phi": return
    Σφ from V's line search at the ACCEPTED candidates — V is the last
    factor updated, and its per-row objective sums the X term, the Y term
    and V's own penalty, so Σφ + R(U) + R(Z) is the eval loss with no
    extra data pass (the sigmoid-X answer; see _aux_loss_phi/_aux_kind)."""
    phi_aux = with_aux == "phi"

    def step(X: Coupled, Y, U, V, Z, hyper: Hyper, rng):
        kU, kZ, kV = jax.random.split(rng, 3)
        common = dict(trials=cfg.line_search_trials,
                      hessian_form=cfg.hessian_form,
                      sample_ratio=cfg.sg_sample_ratio)
        numv_x = gram_u = None
        phi_sum = None

        from ..ops.chunked import is_chunked as _is_ck

        if cfg.update_U:
            chunked = _is_ck(X.A)
            sampled = cfg.sg_sample_ratio < 1.0
            sig_chunked = chunked and cfg.x_link != LINEAR
            # the accumulator-emitting streamed pass only pays off when
            # the V update consumes XᵀU_new/UᵀU (and is full-batch — the
            # sampled draw invalidates the accumulators); U-only
            # fold-ins and sampled fits take the generic Term path below
            chunked = chunked and not sig_chunked and cfg.update_V \
                and not sampled
            if sig_chunked:
                # row-local streamed sigmoid update: one scatter pass
                # per iteration, line search in-chunk
                from .newton_chunked import chunked_sigmoid_row_update

                col_mask = None
                if sampled:
                    # the SAME draw the dense path's term 0 would make
                    # (newton_update_factor: key = fold_in(kU, t=0))
                    col_mask = sample_mask(
                        jax.random.fold_in(kU, 0), X.A.shape[1],
                        cfg.sg_sample_ratio, U.dtype)
                U = chunked_sigmoid_row_update(
                    X.A, U, V, hyper, trials=cfg.line_search_trials,
                    non_negative=cfg.U_non_negative,
                    hessian_form=cfg.hessian_form, col_mask=col_mask)
            elif chunked:
                # streamed scatter+matmul pass (ops/chunked.py) that also
                # emits the V update's XᵀU_new / U_newᵀU_new accumulators
                from ..ops.chunked import chunked_newton_linear_u_pass

                BtB, Hinv, l1, l2 = shared_gauss_hinv(V, hyper)
                U, numv_x, gram_u = chunked_newton_linear_u_pass(
                    X.A, U, V, BtB, Hinv, X.row_sq, l1, l2,
                    trials=cfg.line_search_trials,
                    non_negative=cfg.U_non_negative)
            else:
                U = newton_update_factor(
                    kU, U, (Term(X.A, V, X.row_sq),), (cfg.x_link,), hyper,
                    non_negative=cfg.U_non_negative, **common)
        if cfg.has_Y and cfg.update_Z:
            if _is_ck(Y.A):
                # streamed sigmoid Y (chunked over Y's m rows): Z's
                # rows index Y's columns — the transposed-orientation
                # builders (chunked_sigmoid_colwise_terms, B = V
                # chunked alongside Y's rows) accumulate G/H/φ per
                # chunk; Y's dense form never exists on device
                from ..ops.chunked import ChunkedT

                zterm = Term(ChunkedT(Y.A), V, Y.row_sq_t)
            elif is_sparse(Y.A):
                zterm = Term(Y.At, V, Y.row_sq_t)
            else:
                zterm = Term(Y.A.T, V, Y.row_sq_t)
            Z = newton_update_factor(
                kZ, Z, (zterm,), (cfg.y_link,), hyper,
                non_negative=cfg.Z_non_negative, **common)
        if cfg.update_V:
            if _is_ck(X.A):
                from ..ops.chunked import ChunkedT

                if cfg.x_link != LINEAR:
                    # streamed sigmoid term: G/H accumulate over the
                    # forward chunks, φ streams per candidate
                    terms = (Term(ChunkedT(X.A), U),)
                elif numv_x is not None:
                    # D is a placeholder: with DB/BtB given the linear-
                    # link term never reads it (_accumulate_term)
                    terms = (Term(X.A, U, X.row_sq_t,
                                  DB=numv_x, BtB=gram_u),)
                elif cfg.sg_sample_ratio < 1.0:
                    # sampled linear: the V update draws its own column
                    # (= X-row) subsample — the transposed-orientation
                    # streamed term builds masked DB/BtB/row norms
                    terms = (Term(ChunkedT(X.A), U),)
                else:
                    # V-only update (frozen U): one streamed XᵀU pass —
                    # the rows-sharded layout's chunked V-only contract
                    from ..ops.chunked import chunked_spmm_t

                    terms = (Term(X.A, U, X.row_sq_t,
                                  DB=chunked_spmm_t(X.A, U),
                                  BtB=gram(U)),)
            elif is_sparse(X.A):
                terms = (Term(X.At, U, X.row_sq_t),)
            else:
                terms = (Term(X.A.T, U, X.row_sq_t),)
            links = (cfg.x_link,)
            if cfg.has_Y:
                terms = terms + (Term(Y.A, Z, Y.row_sq),)
                links = links + (cfg.y_link,)
            out = newton_update_factor(
                kV, V, terms, links, hyper,
                non_negative=cfg.V_non_negative,
                return_phi=phi_aux, **common)
            if phi_aux:
                V, phi_rows = out
                phi_sum = jnp.sum(phi_rows)
            else:
                V = out
        if phi_aux:
            assert phi_sum is not None, \
                "phi-aux requires the V update (see _aux_kind)"
            return U, V, Z, phi_sum
        if with_aux:
            assert numv_x is not None, \
                "with_aux requires the chunked U-pass (see _aux_ok)"
            return U, V, Z, (numv_x, gram_u)
        return U, V, Z

    return step


@lru_cache(maxsize=None)
def _aux_loss(cfg: SolverConfig):
    """Loss from the chunked U-pass accumulators — no pass over X.

    Identical in structure to solvers/mu.py:_aux_loss: the linear X term
    via the factored identity with numV = XᵀU_new contracted against the
    post-step V; the (small) Y term evaluated directly."""
    from ..ops.losses import penalty, reconstruction_term

    def loss_fn(state, aux, hyper: Hyper):
        X, Y, U, V, Z = state
        num_vx, gram_u = aux
        inner = jnp.sum(num_vx * V)
        x_term = 0.5 * (X.a_sq - 2.0 * inner + jnp.sum(gram_u * gram(V)))
        loss = x_term + penalty(U, hyper.alpha, hyper.l1_ratio) \
            + penalty(V, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = loss + reconstruction_term(Y.A, V, Z, cfg.y_link,
                                              a_sq=Y.a_sq)
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_ok(cfg: SolverConfig, X: Coupled, U0) -> bool:
    """Aux loss needs a single-X-pass U update emitting fresh XᵀU_new
    each step (the chunked stream), a linear X link (the identity) and a
    full batch."""
    from ..ops.chunked import is_chunked as _is_ck

    return (_is_ck(X.A) and cfg.update_U and cfg.update_V
            and cfg.x_link == LINEAR and cfg.sg_sample_ratio >= 1.0
            and X.a_sq is not None)


@lru_cache(maxsize=None)
def _aux_loss_phi(cfg: SolverConfig):
    """Eval loss from V's accepted-candidate Σφ — no data pass at all.

    V is the last factor updated (pinned U → Z → V order) and its per-row
    line-search objective is ½‖(Xᵀ)ⱼ − f(U vⱼ)‖² + ½‖yⱼ − f(Z vⱼ)‖² +
    l1‖vⱼ‖₁ + ½l2‖vⱼ‖², so Σⱼ φ(V_new) = L_X + L_Y + R(V) at the
    post-step iterate exactly; only the U/Z penalties (factor-sized) are
    added here. Works for ANY link — this is the sigmoid-X zero-extra-pass
    eval (the linear-X case has the cheaper factored identity, _aux_loss)."""
    from ..ops.losses import penalty

    def loss_fn(state, aux, hyper: Hyper):
        X, Y, U, V, Z = state
        loss = aux + penalty(U, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_kind(cfg: SolverConfig, X: Coupled, U0):
    """Which zero-extra-pass eval-loss machinery applies (or None).

    "factored": linear X link, the chunked U-pass emits (XᵀU, UᵀU).
    "phi": any other X link — V's line search evaluates the accepted
    candidate's objective anyway. Needs the V update (the last in the
    step), a real line search (trials ≥ 1), and a full batch (a sampled
    φ describes the subsample, not the data)."""
    if cfg.x_link == LINEAR:
        return "factored" if _aux_ok(cfg, X, U0) else None
    if not (cfg.update_V and cfg.line_search_trials >= 1
            and cfg.sg_sample_ratio >= 1.0):
        return None
    return "phi"


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


def _phi_zero(U, V, Z):
    return jnp.zeros((), U.dtype)


def _aux_fns(cfg: SolverConfig, aux):
    """(aux_loss, aux_init) for an _aux_kind value."""
    if aux == "phi":
        return _aux_loss_phi(cfg), _phi_zero
    return _aux_loss(cfg), _aux_zero


@lru_cache(maxsize=None)
def _make_block(cfg: SolverConfig, aux=False):
    step = make_newton_step(cfg, with_aux=aux)

    @partial(jax.jit, static_argnames=("n_steps",))
    def block(state, hyper: Hyper, rng, n_steps: int):
        # rng = (key, iteration offset): per-iteration keys are fold_in(key,
        # absolute_iter) — the SAME schedule device_fit_core uses, so host-
        # and device-loop fits draw identical sampling streams and stay
        # trajectory-identical even with sg_sample_ratio < 1.
        X, Y, U, V, Z = state
        key, off = rng

        if aux:
            aux_loss, aux_init = _aux_fns(cfg, aux)

            def body(i, carry):
                U, V, Z, _a = carry
                return step(X, Y, U, V, Z, hyper,
                            jax.random.fold_in(key, off + i))

            U, V, Z, a = jax.lax.fori_loop(
                0, n_steps, body, (U, V, Z, aux_init(U, V, Z)))
            loss = aux_loss((X, Y, U, V, Z), a, hyper)
        else:
            def body(i, carry):
                U, V, Z = carry
                return step(X, Y, U, V, Z, hyper,
                            jax.random.fold_in(key, off + i))

            U, V, Z = jax.lax.fori_loop(0, n_steps, body, (U, V, Z))
            loss = _make_loss(cfg)((X, Y, U, V, Z), hyper)
        return (X, Y, U, V, Z), loss, (key, off + n_steps)

    return block


@lru_cache(maxsize=None)
def _make_device_fit(cfg: SolverConfig, aux=False):
    from .common import make_device_fit_loop

    step = make_newton_step(cfg, with_aux=aux)

    def step_fn(X, Y, U, V, Z, hyper, key):
        return step(X, Y, U, V, Z, hyper, key)

    if aux:
        aux_loss, aux_init = _aux_fns(cfg, aux)
        return make_device_fit_loop(step_fn, _loss_core(cfg),
                                    carry_rng=True,
                                    aux_loss=aux_loss,
                                    aux_init=aux_init)
    return make_device_fit_loop(step_fn, _loss_core(cfg), carry_rng=True)


def run_newton(X: Coupled, Y, U0, V0, Z0, cfg: SolverConfig, hyper: Hyper,
               rng, *, max_iter: int = 200, tol: float = 1e-4,
               eval_every: int = 10, verbose: int = 0, loop: str = "host"):
    """Newton solver driver (loop semantics as in run_mu)."""
    import time as _time

    from .common import amortize_step_times, finish_device_fit

    aux = _aux_kind(cfg, X, U0)
    if loop == "device":
        fitf = _make_device_fit(cfg, aux)
        tol_s = jnp.asarray(tol, U0.dtype)
        t0 = _time.perf_counter()
        out = fitf(X, Y, U0, V0, Z0, hyper, rng, tol_s, max_iter,
                   eval_every)
        U, V, Z, n_iter, losses, iters = finish_device_fit(
            out, eval_every, max_iter)
        return U, V, Z, n_iter, losses, iters, \
            amortize_step_times(_time.perf_counter() - t0, iters)

    block = _make_block(cfg, aux)
    loss_fn = _make_loss(cfg)
    state = (X, Y, U0, V0, Z0)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, state, hyper, (rng, jnp.zeros((), jnp.int32)),
        max_iter=max_iter, tol=tol, eval_every=eval_every, verbose=verbose,
        initial_loss_fn=loss_fn,
    )
    _, _, U, V, Z = state
    return U, V, Z, n_iter, losses, iters, times
