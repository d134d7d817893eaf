"""Shared helpers of the sharded-vs-single-device parity tests on the XLA
path (test_parity_rows.py, test_parity_cols.py, test_parity_grid.py)."""
import numpy as np

from pycmf_tpu import CMF
from tests.conftest import make_problem

CASES = [(solver, storage, loop)
         for solver in ("mu", "newton")
         for storage in ("csr", "chunked")
         for loop in ("host", "device")]


def problem(seed=3):
    """The 67×300 sparse matrix (3 column blocks of 128, shard nnz counts
    that differ) and its inits; 67 rows divide neither 8 nor 2."""
    rng = np.random.RandomState(seed)
    X, Y = make_problem(rng, n=67, m=300, sparse=True)
    inits = (np.abs(rng.randn(67, 4)), np.abs(rng.randn(300, 4)),
             np.abs(rng.randn(Y.shape[1], 4)))
    return X, Y, inits


def pair(shard_kw, solver, storage, loop, data_dtype=None, max_iter=6):
    """(single-device, sharded) fits of the same problem and inits."""
    X, Y, (U0, V0, Z0) = problem()
    kw = dict(n_components=4, solver=solver, max_iter=max_iter, tol=0.0,
              eval_every=3, dtype="float64", random_state=0,
              sparse_mode=storage, loop=loop, data_dtype=data_dtype)
    single = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    sharded = CMF(**kw, **shard_kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    return single, sharded


def assert_match(single, sharded, rtol=1e-9, atol=1e-12):
    for a, b in ((single.U_, sharded.U_), (single.V_, sharded.V_),
                 (single.Z_, sharded.Z_)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    np.testing.assert_allclose(sharded.loss_history_, single.loss_history_,
                               rtol=max(rtol, 1e-9))
