"""The batched Newton solve (solvers/newton._solve_direction): SPD systems
go through batched Cholesky, possibly indefinite ones (hessian_form='full')
through pivoted LU, and the all-linear case through one shared k×k solve.
Each route is checked against numpy.linalg.solve in float64."""
import jax.numpy as jnp
import numpy as np
import pytest

from pycmf_tpu.solvers.newton import _solve_direction


def _spd_rows(rng, batch, k):
    A = rng.randn(batch, k, k + 3)
    return A @ A.transpose(0, 2, 1)          # full-rank PSD per row


@pytest.mark.parametrize("damping", [0.0, 0.2, 5.0])
@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("k", [1, 2, 5, 20])
def test_cholesky_route_matches_solve(rng, k, batch, damping):
    H_rows = _spd_rows(rng, batch, k)
    H_shared = damping * np.eye(k)
    G = rng.randn(batch, k)
    d = _solve_direction(jnp.asarray(H_shared), jnp.asarray(H_rows),
                         jnp.asarray(G), spd=True)
    want = np.linalg.solve(H_rows + H_shared[None], G[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(d), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("batch", [1, 5, 32])
def test_indefinite_systems_route_to_lu(rng, batch):
    """hessian_form='full' can make H indefinite: spd=False must solve it
    (an unpivoted Cholesky would return NaN)."""
    k = 4
    Q, _ = np.linalg.qr(rng.randn(k, k))
    eig = np.array([3.0, 1.0, -0.5, 2.0])
    H_rows = np.broadcast_to(Q @ np.diag(eig) @ Q.T, (batch, k, k)).copy()
    G = rng.randn(batch, k)
    H_shared = np.zeros((k, k))
    d = _solve_direction(jnp.asarray(H_shared), jnp.asarray(H_rows),
                         jnp.asarray(G), spd=False)
    want = np.linalg.solve(H_rows, G[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(d), want, rtol=1e-9, atol=1e-12)
    chol = _solve_direction(jnp.asarray(H_shared), jnp.asarray(H_rows),
                            jnp.asarray(G), spd=True)
    assert not np.all(np.isfinite(np.asarray(chol)))


@pytest.mark.parametrize("k", [1, 4, 20])
def test_shared_system_without_row_hessians(rng, k):
    B = rng.randn(k + 5, k)
    H_shared = B.T @ B + 0.2 * np.eye(k)
    G = rng.randn(11, k)
    d = _solve_direction(jnp.asarray(H_shared), None, jnp.asarray(G))
    want = np.linalg.solve(H_shared, G.T).T
    np.testing.assert_allclose(np.asarray(d), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("hessian_form", ["gauss", "full"])
def test_newton_fit_matches_reference(rng, hessian_form):
    """Both routes inside whole fits (sigmoid Y: per-row Hessians)
    against the float64 reference, which solves with numpy.linalg."""
    from baselines import numpy_cmf
    from pycmf_tpu import CMF
    from tests.conftest import make_problem

    X, Y = make_problem(rng, n=31, m=23, r=5, binary_y=True)
    U0, V0, Z0 = (np.abs(rng.randn(s, 3)) for s in (31, 23, 5))
    m = CMF(n_components=3, solver="newton", y_link="sigmoid",
            hessian_form=hessian_form, hessian_pertubation=0.5, max_iter=4,
            eval_every=4, tol=0.0, dtype="float64").fit(
                X, Y, U=U0, V=V0, Z=Z0)
    U, V, Z, _, hist = numpy_cmf.run_newton(
        X, Y, U0.copy(), V0.copy(), Z0.copy(), max_iter=4, tol=0.0,
        eval_every=4, y_link="sigmoid", hessian_form=hessian_form,
        hessian_pertubation=0.5)
    np.testing.assert_allclose(m.V_, V, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(m.loss_history_, hist, rtol=1e-9)
