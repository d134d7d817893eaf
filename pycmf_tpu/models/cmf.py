"""Collective Matrix Factorization estimator (sklearn-style API).

API parity with the reference (SURVEY.md §1 layer map; BASELINE.json
north_star: "sklearn-style estimator ... fit/transform/fit_transform API
parity"): ``CMF(n_components=k, ...)`` jointly factors

    X ≈ f_x(U Vᵀ)   (X: n×m)
    Y ≈ f_y(V Zᵀ)   (Y: m×r, optional)

with a shared V, optional non-negativity per factor, elastic-net
regularization, two solvers ('mu' | 'newton'), linear/sigmoid links,
stochastic column subsampling for Newton, and seeded or externally-supplied
initialization (the 1e-5 parity mechanism).

The estimator is a NumPy-in/NumPy-out shell: validation and initialization
run on the host, the solver loop is a pure jitted function on the device
(SURVEY.md §7 design stance). Multi-chip runs are a property of the arrays,
not the algorithm: pass ``n_shards`` to row-shard the data over a 1-D device
mesh with psum of the shared-V terms (BASELINE.json config #5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..solvers.common import SolverConfig, make_hyper
from ..solvers.mu import run_mu
from ..solvers.newton import run_newton
from ..utils.init import initialize_factors
from ..utils.validation import as_coupled, check_matrix, validate_cmf_params
from .base import EstimatorBase

_DTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
    # fp8 is data_dtype-only (dense X/Y storage at 1 byte/elt — half bf16's
    # memory traffic on the data passes); factors/accumulation never go below
    # bf16/f32, and _resolve_dtype rejects it for the factor dtype.
    "float8_e4m3fn": jnp.float8_e4m3fn,
    "fp8": jnp.float8_e4m3fn,
}
from ..ops.matmul import FP8_DTYPES as _FP8  # noqa: E402 — single policy


def _jax_seed(random_state) -> int:
    """Deterministic JAX PRNG seed from any sklearn-style random_state.

    A passed ``np.random.RandomState`` contributes its current generator
    state (without consuming it), so two differently-seeded instances get
    different Newton sampling streams.
    """
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.get_state()[1][0])
    if isinstance(random_state, (int, np.integer)):
        return int(random_state)
    return 0


class CMF(EstimatorBase):
    """Collective Matrix Factorization.

    Parameters (reference-compatible surface, SURVEY.md §1)
    ----------
    n_components : int — rank k of the factorization.
    solver : 'mu' | 'newton'.
    alpha, l1_ratio : elastic-net regularization (sklearn-NMF-style).
    tol, max_iter : relative-decrease stopping rule (SURVEY.md §0).
    x_link, y_link : 'linear' | 'sigmoid' residual links.
    U_non_negative, V_non_negative, Z_non_negative : constraint flags.
    sg_sample_ratio : Newton stochastic column-subsample ratio.
    hessian_pertubation : Newton diagonal damping (reference spelling).
    x_init, y_init : 'random' | 'svd' | 'nndsvd' | 'nndsvda' | 'nndsvdar'.
    random_state, verbose : usual sklearn semantics.

    Extensions of this build
    ------------------------
    dtype : 'float32' (default) | 'float64' (needs jax_enable_x64)
        — compute/factor dtype (low-precision storage belongs in
        data_dtype; factor updates need f32).
    data_dtype : storage dtype for X/Y on device (None = dtype).
        'bfloat16' halves the memory traffic of the bandwidth-bound data
        passes while factors and accumulation stay float32. 'fp8'
        (float8_e4m3fn) halves it again for dense X (upcast to bf16 for
        each dot; Y stays bf16; factors/accumulation stay float32) —
        quantization noise averages out in the length-m contractions, so
        the loss impact is small, but verify against your tolerance.
    eval_every : iterations between loss/tol checks.
    loop : 'auto' (default) | 'host' | 'device'. 'device' runs the whole
        tol-checked fit as one on-device lax.while_loop (one dispatch per
        fit); 'host' syncs with the host every eval_every iterations.
        'auto' picks per backend (see _resolve_loop). verbose printing
        needs loop='host'.
    sparse_mode : 'auto' (densify sparse input when the dense copy AT THE
        STORAGE DTYPE fits ~2 GB; above that, stream row chunks through a
        reused dense buffer, ops/chunked.py) | 'csr' | 'dense' | 'chunked' (force the
        streaming layout; MU and full-batch Newton — either link — on
        every layout, single-chip or sharded).
    hessian_form : 'gauss' (default) | 'full' Newton Hessian weights.
    line_search_trials : backtracking halvings (0 = full Newton step).
    n_shards : shard data over this many devices (None = single-chip;
        -1 or 'all' = every visible device; a (rows, cols) tuple with
        shard_layout='grid' picks the 2-D mesh shape).
    shard_layout : 'rows' (shard n; default) | 'cols' (shard m) —
        SURVEY.md §7 layouts A and B — | 'grid' (shard BOTH axes over a
        2-D mesh for jointly huge n and m, parallel/grid.py).

    Attributes
    ----------
    U_, V_, Z_ : fitted factors (NumPy).
    reconstruction_err_ : final objective value L(U, V, Z).
    n_iter_ : iterations run.
    loss_history_, loss_iters_, step_times_ : per-eval fit history
        (SURVEY.md §5 metrics/observability).
    """

    def __init__(self, n_components=None, solver="mu", alpha=0.0,
                 l1_ratio=0.0, tol=1e-4, max_iter=200, random_state=None,
                 verbose=0, U_non_negative=True, V_non_negative=True,
                 Z_non_negative=True, x_link="linear", y_link="linear",
                 x_init="random", y_init="random", hessian_pertubation=0.2,
                 sg_sample_ratio=1.0, eps=1e-10, dtype="float32",
                 eval_every=10, hessian_form="gauss",
                 line_search_trials=8, n_shards=None, shard_layout="rows",
                 sparse_mode="auto", loop="auto", data_dtype=None):
        self.n_components = n_components
        self.solver = solver
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.tol = tol
        self.max_iter = max_iter
        self.random_state = random_state
        self.verbose = verbose
        self.U_non_negative = U_non_negative
        self.V_non_negative = V_non_negative
        self.Z_non_negative = Z_non_negative
        self.x_link = x_link
        self.y_link = y_link
        self.x_init = x_init
        self.y_init = y_init
        self.hessian_pertubation = hessian_pertubation
        self.sg_sample_ratio = sg_sample_ratio
        self.eps = eps
        self.dtype = dtype
        self.eval_every = eval_every
        self.hessian_form = hessian_form
        self.line_search_trials = line_search_trials
        self.n_shards = n_shards
        self.shard_layout = shard_layout
        self.sparse_mode = sparse_mode
        self.loop = loop
        self.data_dtype = data_dtype

    # -- internals --------------------------------------------------------

    def _resolve_n_shards(self):
        """-1 or 'all' → every visible device; None/positive-int
        passthrough; a (rows, cols) tuple (grid layout) → its product.

        Any other value raises: a typo like n_shards=0 must not silently
        fall back to a single-chip fit."""
        ns = self.n_shards
        if ns is None:
            return None
        if isinstance(ns, str):
            if ns.lower() == "all":
                return len(jax.devices())
            raise ValueError(
                f"n_shards={ns!r} not understood; use an int, -1, or 'all'")
        if isinstance(ns, (tuple, list)):
            if (len(ns) == 2 and all(
                    isinstance(v, (int, np.integer))
                    and not isinstance(v, bool) and v >= 1 for v in ns)):
                if self.shard_layout != "grid":
                    raise ValueError(
                        "a (rows, cols) n_shards tuple requires "
                        "shard_layout='grid'")
                return int(ns[0]) * int(ns[1])
            raise ValueError(
                f"n_shards={ns!r} not understood; a tuple must be two "
                "positive ints (rows, cols) with shard_layout='grid'")
        if isinstance(ns, (int, np.integer)) and not isinstance(ns, bool):
            if ns == -1:
                return len(jax.devices())
            if ns >= 1:
                return int(ns)
        raise ValueError(
            f"n_shards={ns!r} not understood; use a positive int, -1, "
            "'all', a (rows, cols) tuple, or None")

    def _resolve_grid(self):
        """(rows, cols) mesh shape for shard_layout='grid'."""
        from ..parallel.grid import factor_grid

        ns = self.n_shards
        if isinstance(ns, (tuple, list)):
            return int(ns[0]), int(ns[1])
        return factor_grid(self._resolve_n_shards())

    def _resolve_loop(self):
        """'auto' → the device-resident tol loop on a GPU, the host loop
        elsewhere. On an H100 the device loop measured 0.770 ms/iter
        against the host loop's 0.858 for the 20NG-shaped bf16 MU fit at
        eval_every=10 (chip_smoke.py, phase 'loop'). verbose > 0 needs
        per-eval host readbacks, so auto falls back to the host loop
        rather than silently not printing."""
        if self.loop == "auto":
            if self.verbose:
                return "host"
            return "device" if jax.default_backend() == "gpu" else "host"
        if self.loop not in ("host", "device"):
            raise ValueError("loop must be 'auto', 'host' or 'device'")
        return self.loop

    def _resolve_dtype(self, which=None):
        dt = which if which is not None else self.dtype
        if isinstance(dt, str):
            if dt not in _DTYPES:
                raise ValueError(f"dtype must be one of {list(_DTYPES)}")
            dt = _DTYPES[dt]
        if dt == jnp.float64 and not jax.config.jax_enable_x64:
            raise ValueError(
                "dtype='float64' requires jax_enable_x64; call "
                "jax.config.update('jax_enable_x64', True) first")
        if which is None and dt == jnp.bfloat16:
            raise ValueError(
                "dtype='bfloat16' is not a factor/compute dtype (factor "
                "updates need f32 precision and the solver loops carry "
                "f32 factors); use data_dtype='bfloat16' to halve the "
                "data-pass memory traffic instead")
        if which is None and dt in _FP8:
            raise ValueError(
                "fp8 is a data storage dtype, not a factor/compute dtype; "
                "pass it as data_dtype='fp8' with dtype='float32'")
        return dt

    def _resolve_data_dtype(self):
        """Storage dtype for X/Y on device. data_dtype='bfloat16' halves
        the memory traffic of the data-matrix passes (the MU bottleneck) while
        factors and all accumulation stay in ``dtype`` (float32)."""
        if self.data_dtype is None:
            return self._resolve_dtype()
        return self._resolve_dtype(self.data_dtype)

    def _config(self, has_Y, update_U=True, update_V=True, update_Z=True):
        return SolverConfig(
            x_link=self.x_link, y_link=self.y_link,
            U_non_negative=self.U_non_negative,
            V_non_negative=self.V_non_negative,
            Z_non_negative=self.Z_non_negative,
            update_U=update_U, update_V=update_V, update_Z=update_Z,
            has_Y=has_Y, hessian_form=self.hessian_form,
            line_search_trials=self.line_search_trials,
            sg_sample_ratio=self.sg_sample_ratio,
        )

    def _matrix_sparse_mode(self, A, link, is_x: bool = True):
        """Per-matrix sparse policy. Sigmoid-linked Newton terms are
        densified when the dense copy fits: the solver materializes dense
        (p, q) sigmoid predictions regardless, so CSR storage saves no
        memory on the hot path. A sigmoid-linked sparse Y past
        the densify threshold (or under an explicit sparse_mode='chunked')
        rides the SAME chunked-COO carrier as X — the Z update consumes
        the transposed-orientation streamed terms, V's Y-term the forward
        ones (solvers/newton_chunked.py), so Y's dense form never exists.
        For a linear-linked Y, 'chunked' resolves as 'auto' (CSR spmm
        handles any size without a dense form)."""
        if (self.solver == "newton" and link == "sigmoid"
                and sp.issparse(A)):
            if self.sparse_mode in ("chunked", "auto") \
                    and is_x and self._chunked_ok():
                # streamed sigmoid Newton (solvers/newton_chunked.py):
                # per-chunk predictions, X's dense form never exists —
                # single-chip 'auto' falls back to it past the densify
                # threshold; sharded layouts need the explicit opt-in
                # (the runner's 'auto' would hand CSR shards to terms
                # that require dense or chunked D)
                ns = self._resolve_n_shards()
                if ns is None or ns <= 1 or self.sparse_mode == "chunked":
                    return self.sparse_mode
            if not is_x and self.sparse_mode in ("chunked", "auto"):
                if self.sparse_mode == "chunked":
                    return "chunked"
                from ..utils.validation import DENSIFY_THRESHOLD

                ydt = self._resolve_data_dtype()
                item = (2 if ydt in _FP8    # fp8 X keeps Y at bf16
                        else jnp.dtype(ydt).itemsize)
                if A.shape[0] * A.shape[1] * item > DENSIFY_THRESHOLD:
                    return "chunked"
            if self.sparse_mode == "csr":
                import warnings

                warnings.warn(
                    "sparse_mode='csr' is overridden to 'dense' for a "
                    "sigmoid-linked matrix under solver='newton': the "
                    "Newton update materializes dense sigmoid predictions "
                    "of the same size anyway (sparse_mode='chunked' "
                    "streams them per row chunk)", UserWarning,
                    stacklevel=3)
            return "dense"
        if not is_x and self.sparse_mode == "chunked":
            # 'chunked' is otherwise an X-only layout (the streamed
            # big-matrix passes); a linear-linked Y resolves it as 'auto'
            return "auto"
        return self.sparse_mode

    def _chunked_ok(self) -> bool:
        """Streaming chunked-COO X works for MU and for Newton on every
        layout — linear links through the streamed term passes, sigmoid
        links through the per-chunk streamed predictions
        (solvers/newton_chunked.py: row-local update chunks, rowwise and
        colwise accumulated terms, whichever orientation each layout's
        update needs). Stochastic Newton (sg_sample_ratio < 1) enters
        every streamed pass — single-chip AND the sharded rows/cols/grid
        layouts — as a column mask (solvers/newton.sample_mask: the same
        per-shard draw as the dense path's gather)."""
        return True

    def _stays_sparse(self, A) -> bool:
        """Will this host matrix remain CSR/chunked on device (i.e. NOT a
        dense device array) under the current params? Mirrors as_coupled's
        storage-byte threshold."""
        if not sp.issparse(A):
            return False
        if self.sparse_mode == "dense":
            return False
        if self.sparse_mode in ("csr", "chunked"):
            return True
        from ..utils.validation import DENSIFY_THRESHOLD

        ddt = self._resolve_data_dtype()
        n, m = A.shape
        ns = self._resolve_n_shards()
        if ddt in _FP8:
            # single-chip fp8 densify scatters through a transient f32
            # device buffer (as_coupled), so it counts f32 bytes; sharded
            # fp8 shards are host-densified and uploaded at 1 byte/elt
            # (run_sharded / run_grid count the same way)
            item = 1 if ns is not None and ns > 1 else 4
        else:
            item = jnp.dtype(ddt).itemsize
        if ns is not None and ns > 1:
            # 'auto' under sharding: every layout densifies its LOCAL
            # shard/cell independently against the threshold (run_sharded
            # / run_grid); over-threshold locals stay sparse
            if self.shard_layout == "grid":
                r, c = self._resolve_grid()
                n, m = -(-n // r), -(-m // c)
            elif self.shard_layout == "cols":
                m = -(-m // ns)
            else:
                n = -(-n // ns)
        return n * m * item > DENSIFY_THRESHOLD

    def _validate(self, X, Y):
        validate_cmf_params(
            n_components=self.n_components, solver=self.solver,
            x_link=self.x_link, y_link=self.y_link,
            U_non_negative=self.U_non_negative,
            V_non_negative=self.V_non_negative,
            Z_non_negative=self.Z_non_negative, alpha=self.alpha,
            l1_ratio=self.l1_ratio, tol=self.tol, max_iter=self.max_iter,
            sg_sample_ratio=self.sg_sample_ratio)
        mu = self.solver == "mu"
        X = check_matrix(X, "X", require_non_negative=mu)
        if Y is not None:
            Y = check_matrix(Y, "Y", require_non_negative=mu)
        if self.sparse_mode == "chunked":
            ns = self._resolve_n_shards()
            if ns is not None and ns > 1 \
                    and self.shard_layout not in ("rows", "cols", "grid"):
                raise ValueError(
                    "sparse_mode='chunked' shards in the rows, cols and "
                    "grid layouts (per-shard/per-cell streaming); use "
                    "sparse_mode='auto'")
        if self._resolve_data_dtype() in _FP8:
            # fp8 is a dense-storage format only: CSR segment ops and
            # chunked layouts stay bf16/f32. Sharded fits are fine — each
            # layout stores dense fp8 shards/cells.
            # Only X is stored fp8 (Y is bf16 — see the fit conversion),
            # and a sigmoid-linked Newton X is force-densified by
            # _matrix_sparse_mode — so the check follows the ACTUAL
            # per-matrix storage decision, not the raw sparse_mode.
            if sp.issparse(X) and self._matrix_sparse_mode(
                    X, self.x_link) != "dense" and self._stays_sparse(X):
                raise ValueError(
                    "data_dtype='fp8' requires dense device storage, but "
                    f"X stays CSR under sparse_mode={self.sparse_mode!r}; "
                    "use sparse_mode='dense' (or 'auto' below the densify "
                    "threshold)")
        # Sigmoid-linked sparse X resolves per-matrix (see
        # _matrix_sparse_mode); the sharded runners own the 'dense'
        # host-densify. A sigmoid-linked sparse Y never densifies on the
        # host on ANY layout: rows replicates it (device-densify below the threshold, else
        # the chunked-COO carrier); cols/grid shard Y's rows with m, so
        # each shard streams its local row slice through the same carrier
        # (_prepare_cols / _prepare_grid own the policy).
        # sg_sample_ratio < 1 on CSR/chunked matrices runs via masked
        # sampling (solvers/newton.sample_mask — the same draw as the
        # dense path's gather, entering as a 0/1 mask) on every layout,
        # including the sharded streamed passes; no validation
        # restriction.
        return X, Y

    def _run(self, Xc, Yc, U0, V0, Z0, cfg, rng):
        hyper = make_hyper(self.alpha, self.l1_ratio, self.eps,
                           self.hessian_pertubation, dtype=U0.dtype)
        kw = dict(max_iter=self.max_iter, tol=self.tol,
                  eval_every=self.eval_every, verbose=self.verbose,
                  loop=self._resolve_loop())
        if self.solver == "mu":
            return run_mu(Xc, Yc, U0, V0, Z0, cfg, hyper, **kw)
        return run_newton(Xc, Yc, U0, V0, Z0, cfg, hyper, rng, **kw)

    # -- public API (reference parity) -------------------------------------

    def fit_transform(self, X, Y=None, U=None, V=None, Z=None):
        """Fit the model to (X, Y) and return the factors (U, V, Z).

        U/V/Z, when given, are used as the initial factors — the parity /
        warm-start / resume mechanism (SURVEY.md §0 "Initialization",
        §5 checkpoint row).
        """
        X, Y = self._validate(X, Y)
        if self.n_components is None:
            raise ValueError("n_components must be set")
        k = int(self.n_components)

        U0, V0, Z0 = initialize_factors(
            X, Y, k, x_init=self.x_init, y_init=self.y_init,
            U_non_negative=self.U_non_negative,
            V_non_negative=self.V_non_negative,
            Z_non_negative=self.Z_non_negative,
            random_state=self.random_state, U=U, V=V, Z=Z)

        dt = self._resolve_dtype()
        cfg = self._config(has_Y=Y is not None)
        rng = jax.random.PRNGKey(_jax_seed(self.random_state))

        n_shards = self._resolve_n_shards()
        if n_shards is not None and n_shards > 1 \
                and self.shard_layout == "grid":
            # 2-D grid layout: X sharded over BOTH axes (jointly huge
            # n and m) — parallel/grid.py.
            from ..parallel.grid import run_grid

            hyper = make_hyper(self.alpha, self.l1_ratio, self.eps,
                               self.hessian_pertubation, dtype=dt)
            gddt = self._resolve_data_dtype()
            Uf, Vf, Zf, n_iter, losses, iters, times = run_grid(
                X, Y, U0, V0, Z0, self._config(has_Y=Y is not None),
                hyper, grid=self._resolve_grid(), dtype=dt,
                max_iter=self.max_iter, tol=self.tol,
                eval_every=self.eval_every, verbose=self.verbose,
                solver=self.solver, rng=rng, loop=self._resolve_loop(),
                data_dtype=None if gddt == dt else gddt,
                sparse_mode=self._matrix_sparse_mode(X, self.x_link))
        elif n_shards is not None and n_shards > 1:
            # Multi-chip: operands are split/padded on the host per layout
            # (SURVEY.md §7 stage 6), so hand over host matrices directly.
            from ..parallel.sharded import run_sharded

            hyper = make_hyper(self.alpha, self.l1_ratio, self.eps,
                               self.hessian_pertubation, dtype=dt)
            ddt = self._resolve_data_dtype()
            Uf, Vf, Zf, n_iter, losses, iters, times = run_sharded(
                self.solver, X, Y, U0, V0, Z0, cfg, hyper, rng,
                n_shards=n_shards, layout=self.shard_layout, dtype=dt,
                max_iter=self.max_iter, tol=self.tol,
                eval_every=self.eval_every, verbose=self.verbose,
                # per-matrix resolution, same as transform and the grid
                # path: a sigmoid x_link resolves sparse X to 'dense'
                # (run_sharded host-densifies it) unless the streamed
                # chunked layout is explicitly requested
                loop=self._resolve_loop(),
                sparse_mode=self._matrix_sparse_mode(X, self.x_link),
                data_dtype=None if ddt == dt else ddt)
        else:
            ddt = self._resolve_data_dtype()
            # fp8 storage is for the BIG matrix (X's data passes are the
            # bottleneck); the small Y stays bf16 — quantizing it saves
            # nothing and costs label precision.
            ydt = jnp.bfloat16 if ddt in _FP8 else ddt
            Xc = as_coupled(X, ddt,
                            sparse_mode=self._matrix_sparse_mode(
                                X, self.x_link),
                            chunked_ok=self._chunked_ok())
            Yc = (as_coupled(Y, ydt,
                             sparse_mode=self._matrix_sparse_mode(
                                 Y, self.y_link, is_x=False))
                  if Y is not None else None)
            U0 = jnp.asarray(U0, dtype=dt)
            V0 = jnp.asarray(V0, dtype=dt)
            Z0 = jnp.asarray(Z0, dtype=dt) if Z0 is not None else \
                jnp.zeros((0, k), dtype=dt)
            Uf, Vf, Zf, n_iter, losses, iters, times = self._run(
                Xc, Yc, U0, V0, Z0, cfg, rng)

        self.U_ = np.asarray(jax.device_get(Uf), dtype=np.float64)
        self.V_ = np.asarray(jax.device_get(Vf), dtype=np.float64)
        self.Z_ = (np.asarray(jax.device_get(Zf), dtype=np.float64)
                   if Y is not None else None)
        self.n_iter_ = int(n_iter)
        self.loss_history_ = [float(v) for v in losses]
        self.loss_iters_ = list(iters)
        self.step_times_ = list(times)
        self.reconstruction_err_ = self.loss_history_[-1]
        self.n_components_ = k
        return self.U_, self.V_, self.Z_

    def fit(self, X, Y=None, **params):
        """Fit and return self (delegates to fit_transform, SURVEY.md §3.2)."""
        self.fit_transform(X, Y, **params)
        return self

    def transform(self, X, U=None):
        """Fold-in: solve for U on new rows of X holding the fitted V fixed
        (SURVEY.md §3.3: same solver machinery with V, Z frozen).

        With ``n_shards > 1`` the fold-in itself is sharded: X's new rows
        are row-sharded over the mesh with V replicated (U's update is
        row-local, so the only collectives are the loss psums) — a
        multi-device fit can fold in X too large for one device.
        The rows layout is used regardless of the fit-time ``shard_layout``
        because transform's natural axis is always the new-row axis.
        """
        if not hasattr(self, "V_"):
            raise RuntimeError("transform called before fit")
        mu = self.solver == "mu"
        X = check_matrix(X, "X", require_non_negative=mu)
        n, m = X.shape
        if m != self.V_.shape[0]:
            raise ValueError(
                f"X has {m} columns; fitted V expects {self.V_.shape[0]}")
        k = self.n_components_
        dt = self._resolve_dtype()

        if U is None:
            rng_np = (self.random_state
                      if isinstance(self.random_state, np.random.RandomState)
                      else np.random.RandomState(
                          self.random_state
                          if isinstance(self.random_state, (int, np.integer))
                          else None))
            mean = float(X.mean())
            avg = np.sqrt(max(abs(mean), 1e-12) / k)
            U0 = avg * rng_np.standard_normal((n, k))
            if self.U_non_negative:
                np.abs(U0, out=U0)
        else:
            U0 = np.asarray(U, dtype=np.float64)

        cfg = self._config(has_Y=False, update_U=True, update_V=False,
                           update_Z=False)
        hyper = make_hyper(self.alpha, self.l1_ratio, self.eps,
                           self.hessian_pertubation, dtype=dt)
        rng = jax.random.PRNGKey(_jax_seed(self.random_state))
        kw = dict(max_iter=self.max_iter, tol=self.tol,
                  eval_every=self.eval_every, verbose=self.verbose,
                  loop=self._resolve_loop())

        n_shards = self._resolve_n_shards()
        if n_shards is not None and n_shards > 1:
            from ..parallel.sharded import run_sharded

            ddt = self._resolve_data_dtype()
            Uf, _, _, _, _, _, _ = run_sharded(
                self.solver, X, None, np.asarray(U0, dtype=np.float64),
                self.V_, None, cfg, hyper, rng, n_shards=n_shards,
                layout="rows", dtype=dt,
                # per-matrix resolution, NOT the raw kwarg: a sigmoid
                # x_link must densify here exactly as fit-time
                # _validate does, or the sharded fold-in crashes on
                # sparse X where the single-chip fold-in works
                sparse_mode=self._matrix_sparse_mode(X, self.x_link),
                data_dtype=None if ddt == dt else ddt, **kw)
            return np.asarray(jax.device_get(Uf), dtype=np.float64)

        Xc = as_coupled(X, self._resolve_data_dtype(),
                        sparse_mode=self._matrix_sparse_mode(X, self.x_link),
                        chunked_ok=self._chunked_ok())
        V0 = jnp.asarray(self.V_, dtype=dt)
        U0 = jnp.asarray(U0, dtype=dt)
        Z0 = jnp.zeros((0, k), dtype=dt)
        if self.solver == "mu":
            Uf, _, _, _, _, _, _ = run_mu(Xc, None, U0, V0, Z0, cfg, hyper,
                                          **kw)
        else:
            Uf, _, _, _, _, _, _ = run_newton(Xc, None, U0, V0, Z0, cfg,
                                              hyper, rng, **kw)
        return np.asarray(jax.device_get(Uf), dtype=np.float64)

    def get_feature_names_out(self, input_features=None):
        """sklearn-pipeline compatibility: names of the k output columns
        (the transformed U's components)."""
        if not hasattr(self, "n_components_"):
            raise AttributeError(
                "get_feature_names_out is only available after fit")
        return np.asarray([f"cmf{i}" for i in range(self.n_components_)],
                          dtype=object)

    @property
    def components_(self):
        """sklearn-NMF-style components (k × m): X ≈ transform(X) @ components_."""
        if not hasattr(self, "V_"):
            raise AttributeError("components_ is only available after fit")
        return self.V_.T

    def inverse_transform(self, U):
        """Reconstruct X rows from factor rows: f_x(U Vᵀ)."""
        if not hasattr(self, "V_"):
            raise RuntimeError("inverse_transform called before fit")
        T = np.asarray(U) @ self.V_.T
        if self.x_link == "sigmoid":
            return 1.0 / (1.0 + np.exp(-T))
        return T

    # -- analysis helpers (SURVEY.md §2 component 5, §3.5) -----------------

    def print_topic_terms(self, vectorizer=None, vocabulary=None,
                          factor="U", n_top_words=10, file=None):
        """Print the top-weighted terms per component.

        In the 20NG supervised-topics orientation (X = term×document,
        Y = document×label; SURVEY.md §0 flagship use case mapped onto the
        X≈UVᵀ/Y≈VZᵀ contract) the term factor is U; pass factor='V' if your
        vocabulary indexes X's columns instead.
        """
        from ..utils.analysis import topic_terms_string

        M = {"U": getattr(self, "U_", None),
             "V": getattr(self, "V_", None),
             "Z": getattr(self, "Z_", None)}[factor]
        if M is None:
            raise RuntimeError("model is not fitted (or factor is absent)")
        s = topic_terms_string(M, vectorizer=vectorizer,
                               vocabulary=vocabulary,
                               n_top_words=n_top_words)
        print(s, file=file)
        return s
