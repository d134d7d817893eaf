"""Input/parameter validation for the CMF estimator.

Mirrors the reference's sklearn-style checks (SURVEY.md §2 component 2:
``check_array``-based validation including scipy.sparse acceptance) while
producing device-ready operands: dense inputs become jnp arrays, sparse
inputs become CsrMatrix pytrees with precomputed transposes
(SURVEY.md §7 stage 4).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..ops.links import LINEAR, SIGMOID
from ..ops.sparse import csr_transpose_host
from ..ops.matmul import FP8_DTYPES
from ..solvers.common import Coupled


# Sparse input whose dense copy at the storage dtype fits this many bytes
# is densified ('auto'), on the reasoning that at CMF ranks one dense
# matmul pass beats per-nonzero gather/scatter work. The value is not
# measured on the GPU; a size- and density-driven rule is pending a
# measured comparison of SpMM against the dense pass (ROADMAP A3).
DENSIFY_THRESHOLD = 1 << 31  # 2 GB


def check_fp8_range(A, dtype) -> None:
    """Fail loudly when |A| exceeds the fp8 storage range.

    fp8 overflow does NOT saturate cleanly (e4m3 has no inf: values past
    ~±448 convert to NaN) — a silent NaN at ingest surfaces as a confusing
    diverged-fit error later. Shared by as_coupled and the sharded runners
    (run_sharded / run_grid), which build their fp8 shards directly.
    """
    fmax = float(jnp.finfo(dtype).max)
    amax = float(abs(A).max() if not sp.issparse(A)
                 else (abs(A.data).max() if A.nnz else 0.0))
    if amax > fmax:
        raise ValueError(
            f"data max |x| = {amax:.4g} exceeds {jnp.dtype(dtype).name}"
            f"'s range (±{fmax:.0f}); scale the data (e.g. X / c) or "
            "use data_dtype='bfloat16'")


def scatter_densify(A, dtype):
    """Densify a scipy-sparse matrix ON DEVICE: upload only the COO
    nonzeros and scatter into device zeros (~nnz·9 bytes copied
    instead of the full dense matrix — see as_coupled's dense branch for
    the rationale). The scatter runs AT the storage dtype (duplicates are
    summed on the host first, so ``.set`` is exact); fp8 detours through
    a small f32 buffer (fp8 scatter support is uncertain across backends).
    """
    coo = A.tocoo()
    coo.sum_duplicates()
    scat_dt = jnp.float32 if dtype in FP8_DTYPES else dtype
    Ad = jnp.zeros(A.shape, scat_dt).at[
        jnp.asarray(coo.row), jnp.asarray(coo.col)].set(
        jnp.asarray(coo.data, dtype=scat_dt))
    if jnp.dtype(dtype) != jnp.dtype(scat_dt):
        Ad = Ad.astype(dtype)
    return Ad


def as_coupled(A, dtype, sparse_mode: str = "auto",
               densify_threshold: int = DENSIFY_THRESHOLD,
               chunked_ok: bool = False) -> Coupled:
    """Convert a host matrix to device operands.

    (See also check_fp8_range, shared with the sharded runners.)

    sparse_mode (a policy of this build, not in the reference):
      'auto'  — densify when the dense copy AT THE STORAGE DTYPE fits the
                threshold (bf16 storage doubles the densify reach). Above
                the threshold: chunked streaming (chunked_ok,
                ops/chunked.py), else segment-sum CSR.
      'csr'   — always keep CSR.
      'dense' — always densify.
      'chunked' — force the streaming chunked-COO layout.

    chunked_ok: allow 'auto' to resolve to the chunked layout — the caller
    asserts the consumer handles ChunkedCoo (MU solver; Newton terms
    don't, they keep CSR).
    """
    fdt = (jnp.float32 if dtype in (jnp.bfloat16,) + FP8_DTYPES
           else dtype)
    if dtype in FP8_DTYPES:
        check_fp8_range(A, dtype)

    def _dense_coupled(Ah):
        if dtype in FP8_DTYPES:
            # loss convention for fp8: norms of the STORED (quantized)
            # values. fp8 quantization error is ~2⁻³ relative, so
            # unquantized norms would bias the factored-identity loss by
            # ~0.5% against the residual the solver actually fits (and
            # against _linear_term's small-size direct path). bf16 keeps
            # the long-standing unquantized-norms convention — its bias
            # is negligible (ops/losses.py _linear_term).
            Ah = np.asarray(Ah).astype(dtype).astype(np.float64)
        sq = Ah.astype(np.float64) ** 2
        return Coupled(
            jnp.asarray(Ah, dtype=dtype),
            row_sq=jnp.asarray(sq.sum(axis=1), dtype=fdt),
            row_sq_t=jnp.asarray(sq.sum(axis=0), dtype=fdt),
            a_sq=jnp.asarray(sq.sum(), dtype=fdt))

    if not sp.issparse(A):
        # dense host input ignores sparse_mode (incl. 'chunked'), matching
        # the long-standing 'csr' behavior: dense arrays upload as-is
        return _dense_coupled(np.asarray(A))

    mode = sparse_mode
    if mode not in ("auto", "csr", "dense", "chunked"):
        raise ValueError(
            f"sparse_mode must be 'auto', 'csr', 'dense' or 'chunked', "
            f"got {mode!r}")
    # Threshold on STORAGE bytes: bf16 storage halves the dense footprint,
    # doubling the densify reach. fp8 still counts f32 bytes — its scatter
    # detours through a transient f32 buffer (see the dense branch).
    item = (4 if dtype in FP8_DTYPES
            else jnp.dtype(dtype).itemsize)
    nbytes_dense = A.shape[0] * A.shape[1] * item
    if mode == "auto":
        mode = ("dense" if nbytes_dense <= densify_threshold
                else ("chunked" if chunked_ok else "csr"))
    if mode == "chunked":
        if dtype in FP8_DTYPES:
            raise ValueError(
                "fp8 data storage requires dense device form; the chunked "
                "streaming layout stores COO + a transient dense chunk — "
                "use data_dtype='bfloat16' for beyond-threshold X")
        from ..ops.chunked import chunked_from_scipy

        Asq = A.multiply(A)
        return Coupled(
            chunked_from_scipy(A, dtype=dtype),
            row_sq=jnp.asarray(np.asarray(Asq.sum(axis=1)).ravel(),
                               dtype=fdt),
            row_sq_t=jnp.asarray(np.asarray(Asq.sum(axis=0)).ravel(),
                                 dtype=fdt),
            a_sq=jnp.asarray(np.asarray(Asq.sum()), dtype=fdt))
    if mode == "csr" and dtype in FP8_DTYPES:
        # The storage layer owns this rule so fit, transform, and direct
        # callers all get the clean error (CSR segment ops have no fp8
        # promotion path; sq_norm at fp8 would silently saturate).
        raise ValueError(
            "fp8 data storage requires dense device form, but this matrix "
            "resolves to CSR (sparse_mode="
            f"{sparse_mode!r}, dense copy {nbytes_dense / 2**30:.2f} GiB); "
            "use sparse_mode='dense', shrink the matrix, or "
            "data_dtype='bfloat16'")
    if mode == "dense":
        # Densify ON DEVICE: upload only the nonzeros (COO triplets) and
        # scatter into device zeros. The host→device copy moves ~nnz·9
        # bytes instead of the full dense matrix — at 20NG scale ~7 MB
        # instead of 0.7-1.4 GB. The one-time scatter compiles to a
        # single XLA scatter.
        coo = A.tocoo()
        coo.sum_duplicates()
        if dtype in FP8_DTYPES:
            # quantized-norms convention (see _dense_coupled); the f32
            # detour mirrors scatter_densify's f32→fp8 convert
            sq64 = (coo.data.astype(np.float32).astype(dtype)
                    .astype(np.float64) ** 2)
        else:
            sq64 = coo.data.astype(np.float64) ** 2
        n, m = A.shape
        row_sq = np.zeros(n)
        np.add.at(row_sq, coo.row, sq64)
        col_sq = np.zeros(m)
        np.add.at(col_sq, coo.col, sq64)
        return Coupled(
            scatter_densify(A, dtype),
            row_sq=jnp.asarray(row_sq, dtype=fdt),
            row_sq_t=jnp.asarray(col_sq, dtype=fdt),
            a_sq=jnp.asarray(sq64.sum(), dtype=fdt))

    C, Ct = csr_transpose_host(A, dtype=dtype)
    # Row norms stay in fdt (float32 under bf16 data): they feed the Newton
    # line-search objective, where bf16 quantization would bias the
    # accept/reject decisions (the dense branch does the same).
    row_sq = jnp.asarray(
        np.asarray(A.multiply(A).sum(axis=1)).ravel(), dtype=fdt)
    row_sq_t = jnp.asarray(
        np.asarray(A.multiply(A).sum(axis=0)).ravel(), dtype=fdt)
    return Coupled(C, Ct, row_sq, row_sq_t)


def check_matrix(A, name: str, *, require_non_negative: bool,
                 require_finite: bool = True):
    if sp.issparse(A):
        data = A.data
    else:
        A = np.asarray(A)
        if A.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {A.shape}")
        data = A
    if data.size and require_finite and not np.all(np.isfinite(data)):
        raise ValueError(f"{name} contains NaN or infinity")
    if require_non_negative and data.size and (data < 0).any():
        raise ValueError(
            f"{name} contains negative entries, which the multiplicative-"
            "update solver cannot handle; use solver='newton'")
    return A


def validate_cmf_params(*, n_components, solver, x_link, y_link,
                        U_non_negative, V_non_negative, Z_non_negative,
                        alpha, l1_ratio, tol, max_iter, sg_sample_ratio):
    if n_components is not None and (not isinstance(n_components, (int, np.integer))
                                     or n_components <= 0):
        raise ValueError(f"n_components must be a positive int, got {n_components!r}")
    if solver not in ("mu", "newton"):
        raise ValueError(f"solver must be 'mu' or 'newton', got {solver!r}")
    for nm, link in (("x_link", x_link), ("y_link", y_link)):
        if link not in (LINEAR, SIGMOID):
            raise ValueError(f"{nm} must be 'linear' or 'sigmoid', got {link!r}")
    if solver == "mu":
        # As in the reference: MU is the Lee–Seung scheme — it requires the
        # linear link and non-negativity on every factor (SURVEY.md §0).
        if x_link != LINEAR or y_link != LINEAR:
            raise ValueError("solver='mu' supports only linear links; "
                             "use solver='newton' for sigmoid links")
        if not (U_non_negative and V_non_negative and Z_non_negative):
            raise ValueError("solver='mu' requires all factors non-negative; "
                             "use solver='newton' to allow negative factors")
    if not (0 <= l1_ratio <= 1):
        raise ValueError(f"l1_ratio must be in [0, 1], got {l1_ratio}")
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    if max_iter <= 0:
        raise ValueError(f"max_iter must be positive, got {max_iter}")
    if tol < 0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    if not (0.0 < sg_sample_ratio <= 1.0):
        raise ValueError(f"sg_sample_ratio must be in (0, 1], got {sg_sample_ratio}")
