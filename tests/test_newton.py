"""Newton solver tests: golden parity vs the NumPy oracle, sigmoid link,
constraints, sampling, damping (SURVEY.md §4, BASELINE.json configs #2/#4)."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from baselines import numpy_cmf  # noqa: E402

from pycmf_tpu import CMF  # noqa: E402
from pycmf_tpu.solvers.common import Coupled, SolverConfig, make_hyper  # noqa: E402
from pycmf_tpu.solvers.newton import make_newton_step  # noqa: E402
from tests.conftest import make_problem  # noqa: E402


def _factors(rng, n, m, r, k, non_negative=True):
    U, V, Z = rng.randn(n, k), rng.randn(m, k), rng.randn(r, k)
    if non_negative:
        U, V, Z = np.abs(U), np.abs(V), np.abs(Z)
    return U, V, Z


class TestNewtonStepGolden:
    @pytest.mark.parametrize("x_link,y_link,nonneg", [
        ("linear", "linear", True),
        ("linear", "sigmoid", False),
        ("sigmoid", "sigmoid", False),
    ])
    def test_step_matches_numpy(self, rng, x_link, y_link, nonneg):
        X, Y = make_problem(rng, non_negative=nonneg,
                            binary_y=(y_link == "sigmoid"))
        if x_link == "sigmoid":
            X = (X > np.median(X)).astype(float)
        U0, V0, Z0 = _factors(rng, *X.shape, Y.shape[1], 4, nonneg)
        cfg = SolverConfig(x_link=x_link, y_link=y_link,
                           U_non_negative=nonneg, V_non_negative=nonneg,
                           Z_non_negative=nonneg, line_search_trials=6)
        step = make_newton_step(cfg)
        hyper = make_hyper(0.1, 0.4, 1e-10, 0.2, dtype=jnp.float64)
        key = jax.random.PRNGKey(0)
        U1, V1, Z1 = step(Coupled(jnp.asarray(X)), Coupled(jnp.asarray(Y)),
                          jnp.asarray(U0), jnp.asarray(V0), jnp.asarray(Z0),
                          hyper, key)
        U2, V2, Z2 = numpy_cmf.newton_step(
            X, Y, U0, V0, Z0, alpha=0.1, l1_ratio=0.4,
            hessian_pertubation=0.2, x_link=x_link, y_link=y_link,
            non_negative=(nonneg,) * 3, trials=6)
        assert np.allclose(U1, U2, rtol=1e-8, atol=1e-10)
        assert np.allclose(V1, V2, rtol=1e-8, atol=1e-10)
        assert np.allclose(Z1, Z2, rtol=1e-8, atol=1e-10)

    def test_full_hessian_matches_numpy(self, rng):
        X, Y = make_problem(rng, non_negative=False, binary_y=True)
        U0, V0, Z0 = _factors(rng, *X.shape, Y.shape[1], 4, False)
        cfg = SolverConfig(x_link="linear", y_link="sigmoid",
                           U_non_negative=False, V_non_negative=False,
                           Z_non_negative=False, hessian_form="full",
                           line_search_trials=6)
        step = make_newton_step(cfg)
        hyper = make_hyper(0.0, 0.0, 1e-10, 0.5, dtype=jnp.float64)
        U1, V1, Z1 = step(Coupled(jnp.asarray(X)), Coupled(jnp.asarray(Y)),
                          jnp.asarray(U0), jnp.asarray(V0), jnp.asarray(Z0),
                          hyper, jax.random.PRNGKey(0))
        U2, V2, Z2 = numpy_cmf.newton_step(
            X, Y, U0, V0, Z0, hessian_pertubation=0.5, y_link="sigmoid",
            non_negative=(False,) * 3, trials=6, hessian_form="full")
        assert np.allclose(U1, U2, rtol=1e-8, atol=1e-10)
        assert np.allclose(V1, V2, rtol=1e-8, atol=1e-10)
        assert np.allclose(Z1, Z2, rtol=1e-8, atol=1e-10)

    def test_sparse_linear_step_matches_numpy(self, rng):
        X, Y = make_problem(rng, sparse=True)
        U0, V0, Z0 = _factors(rng, *X.shape, Y.shape[1], 4)
        from pycmf_tpu.utils.validation import as_coupled

        cfg = SolverConfig(line_search_trials=6)
        step = make_newton_step(cfg)
        hyper = make_hyper(0.05, 0.2, 1e-10, 0.2, dtype=jnp.float64)
        U1, V1, Z1 = step(as_coupled(X, jnp.float64),
                          as_coupled(Y, jnp.float64),
                          jnp.asarray(U0), jnp.asarray(V0), jnp.asarray(Z0),
                          hyper, jax.random.PRNGKey(0))
        U2, V2, Z2 = numpy_cmf.newton_step(
            X, Y, U0, V0, Z0, alpha=0.05, l1_ratio=0.2, trials=6)
        assert np.allclose(U1, U2, rtol=1e-8, atol=1e-10)
        assert np.allclose(V1, V2, rtol=1e-8, atol=1e-10)


class TestNewtonTrajectoryGolden:
    def test_10_iter_trajectory_matches_numpy(self, rng):
        """Multi-iteration loss-trajectory parity vs the independent NumPy
        oracle in float64 (the BASELINE 1e-5 bar, SURVEY.md §4b)."""
        X, Y = make_problem(rng, non_negative=False, binary_y=True)
        U0, V0, Z0 = _factors(rng, *X.shape, Y.shape[1], 4, False)
        m = CMF(n_components=4, solver="newton", y_link="sigmoid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, dtype="float64", max_iter=10, tol=0.0,
                eval_every=2, alpha=0.02, l1_ratio=0.1,
                line_search_trials=6)
        m.fit(X, Y, U=U0, V=V0, Z=Z0)
        _, _, _, _, hist = numpy_cmf.run_newton(
            X, Y, U0.copy(), V0.copy(), Z0.copy(), max_iter=10, tol=0.0,
            eval_every=2, alpha=0.02, l1_ratio=0.1, y_link="sigmoid",
            non_negative=(False,) * 3, trials=6)
        ours = np.array(m.loss_history_)
        ref = np.array(hist)
        assert ours.shape == ref.shape
        assert np.allclose(ours, ref, rtol=1e-7)


class TestNewtonBehavior:
    def test_loss_decreases(self, problem):
        X, Y = problem
        m = CMF(n_components=4, solver="newton", random_state=0,
                max_iter=30, tol=0.0, eval_every=5)
        m.fit(X, Y)
        h = np.array(m.loss_history_)
        assert h[-1] < h[0] * 0.5
        assert np.all(np.diff(h) <= 1e-6 * h[0])  # line search guarantees

    def test_sigmoid_binary_converges(self, rng):
        """Config #2: sigmoid link on a binary label matrix."""
        X, Y = make_problem(rng, non_negative=False, binary_y=True)
        m = CMF(n_components=4, solver="newton", y_link="sigmoid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, random_state=0, max_iter=50, tol=1e-8)
        U, V, Z = m.fit_transform(X, Y)
        P = 1 / (1 + np.exp(-(V @ Z.T)))
        acc = ((P > 0.5) == (Y > 0.5)).mean()
        assert acc > 0.95

    def test_negatives_allowed(self, rng):
        X, Y = make_problem(rng, non_negative=False)
        m = CMF(n_components=4, solver="newton", U_non_negative=False,
                V_non_negative=False, Z_non_negative=False, random_state=0,
                max_iter=40, tol=1e-9)
        U, V, Z = m.fit_transform(X, Y)
        assert (U < 0).any()  # negative entries actually used
        rel = np.linalg.norm(X - U @ V.T) / np.linalg.norm(X)
        assert rel < 0.05

    def test_non_negativity_respected(self, problem):
        X, Y = problem
        m = CMF(n_components=4, solver="newton", random_state=0, max_iter=20)
        U, V, Z = m.fit_transform(X, Y)
        assert (U >= 0).all() and (V >= 0).all() and (Z >= 0).all()

    def test_stochastic_sampling_decreases_loss(self, rng):
        """Config #4: row-sampled (column-subsampled) stochastic Newton."""
        X, Y = make_problem(rng, n=200, m=80)
        m = CMF(n_components=4, solver="newton", sg_sample_ratio=0.4,
                random_state=0, max_iter=40, tol=0.0)
        m.fit(X, Y)
        assert m.loss_history_[-1] < m.loss_history_[0] * 0.3

    def test_no_line_search_full_step(self, problem):
        X, Y = problem
        m = CMF(n_components=4, solver="newton", line_search_trials=0,
                random_state=0, max_iter=30, tol=0.0)
        m.fit(X, Y)
        assert m.loss_history_[-1] < m.loss_history_[0]

    def test_large_k_beyond_unroll_cap(self, rng):
        """k > the batched-solve unroll cap exercises the XLA fallback
        inside the full solver (sigmoid → per-row Hessians)."""
        X, Y = make_problem(rng, n=80, m=50, r=40, k=8, non_negative=False,
                            binary_y=True)
        m = CMF(n_components=36, solver="newton", y_link="sigmoid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, random_state=0,
                max_iter=5, tol=0.0)
        m.fit(X, Y)
        assert m.loss_history_[-1] < m.loss_history_[0]

    def test_single_column_y(self, rng):
        X, Y = make_problem(rng, r=1)
        m = CMF(n_components=3, solver="newton", random_state=0, max_iter=10)
        m.fit(X, Y)
        assert m.Z_.shape == (1, 3)
        assert np.isfinite(m.reconstruction_err_)

    def test_k1(self, rng):
        X, Y = make_problem(rng)
        m = CMF(n_components=1, solver="newton", random_state=0, max_iter=10)
        U, V, Z = m.fit_transform(X, Y)
        assert U.shape[1] == 1 and np.isfinite(m.reconstruction_err_)

    def test_damping_keeps_finite(self, rng):
        X, Y = make_problem(rng, noise=0.0)
        m = CMF(n_components=4, solver="newton", hessian_pertubation=1e-3,
                random_state=0, max_iter=20)
        m.fit(X, Y)
        assert np.all(np.isfinite(m.U_))
        assert np.all(np.isfinite(m.V_))


class TestNewtonAuxLoss:
    """Zero-extra-pass Newton loss evals (aux from the streamed chunked
    U-pass) must give the same history and stopping decisions as the
    float64 reference's standalone loss evals."""

    def test_fit_histories_match_with_tol_stopping(self, rng):
        import scipy.sparse as sp

        from baselines import numpy_cmf
        from tests.conftest import make_problem

        from pycmf_tpu import CMF

        X, Y = make_problem(rng, n=60, m=40, binary_y=True)
        Xs = sp.csr_matrix(X * (X > np.median(X)))
        U0 = np.abs(rng.randn(60, 4))
        V0 = np.abs(rng.randn(40, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="newton", y_link="sigmoid",
                  max_iter=30, tol=1e-7, eval_every=2, dtype="float64",
                  random_state=0, sparse_mode="chunked")
        m = CMF(**kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        U, V, Z, n_iter, hist = numpy_cmf.run_newton(
            Xs, Y, U0.copy(), V0.copy(), Z0.copy(), max_iter=30, tol=1e-7,
            eval_every=2, y_link="sigmoid")
        assert m.n_iter_ == n_iter
        assert np.allclose(m.loss_history_, hist, rtol=1e-9)
        assert np.allclose(m.U_, U, rtol=1e-7, atol=1e-9)

    def test_device_loop_aux_matches_host(self, rng):
        from tests.conftest import make_problem

        from pycmf_tpu import CMF

        import scipy.sparse as sp

        X, Y = make_problem(rng, n=60, m=40, sparse=True)
        U0 = np.abs(rng.randn(60, 4))
        V0 = np.abs(rng.randn(40, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="newton", sparse_mode="chunked",
                  max_iter=12, tol=1e-7, eval_every=5, dtype="float64",
                  random_state=0)
        assert sp.issparse(X)
        m1 = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert m1.n_iter_ == m2.n_iter_
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-12)
