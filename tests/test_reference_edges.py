"""The XLA path against the float64 NumPy reference (baselines/numpy_cmf.py)
at shapes that are not multiples of any tile: one-row and one-column-ish
problems, odd sizes, and a wide m. Dense and CSR storage, MU and Newton
(sigmoid-linked Y), from the same inits for the same iteration count."""
import numpy as np
import pytest
import scipy.sparse as sp

from baselines import numpy_cmf
from pycmf_tpu import CMF

SHAPES = [(67, 53), (129, 7), (5, 300), (33, 65), (1, 9)]


@pytest.mark.parametrize("storage", ["dense", "csr"])
@pytest.mark.parametrize("solver", ["mu", "newton"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_matches_float64_reference(n, m, solver, storage):
    rng = np.random.RandomState(n * 1000 + m)
    k, r = 3, 4
    X = np.abs(rng.randn(n, m)) * (rng.rand(n, m) > 0.4)
    Y = np.abs(rng.randn(m, r))
    if solver == "newton":
        Y = (Y > np.median(Y)).astype(float)
    U0, V0, Z0 = (np.abs(rng.randn(s, k)) + 0.1 for s in (n, m, r))
    Xa = sp.csr_matrix(X) if storage == "csr" else X
    kw = dict(alpha=0.05, l1_ratio=0.3)
    y_link = "sigmoid" if solver == "newton" else "linear"
    iters = 6 if solver == "newton" else 15
    model = CMF(n_components=k, solver=solver, y_link=y_link, tol=0.0,
                max_iter=iters, eval_every=iters, dtype="float64",
                sparse_mode=storage, **kw).fit(Xa, Y, U=U0, V=V0, Z=Z0)
    if solver == "mu":
        U, V, Z, _, hist = numpy_cmf.run_mu(
            Xa, Y, U0.copy(), V0.copy(), Z0.copy(), max_iter=iters,
            tol=0.0, eval_every=iters, **kw)
    else:
        U, V, Z, _, hist = numpy_cmf.run_newton(
            Xa, Y, U0.copy(), V0.copy(), Z0.copy(), max_iter=iters,
            tol=0.0, eval_every=iters, y_link=y_link, **kw)
    np.testing.assert_allclose(model.U_, U, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(model.V_, V, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(model.Z_, Z, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(model.loss_history_, hist, rtol=1e-9)
