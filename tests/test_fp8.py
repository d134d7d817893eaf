"""fp8 (float8_e4m3fn) data-storage path: dense X is stored at 1 byte per
entry and upcast to bf16 for each dot; factors/accumulation stay float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycmf_tpu import CMF
from tests.conftest import make_problem


def _fp8_exact(rng, n, m):
    """Non-negative matrix whose entries are exactly representable in
    e4m3 (small integer halves), so quantization is a no-op and kernel
    outputs can be compared at matmul precision."""
    return (rng.randint(0, 8, size=(n, m)) * 0.5).astype(np.float64)


class TestEstimatorFp8:
    def test_mu_fit_close_to_bf16(self, rng):
        X, Y = make_problem(rng, n=64, m=48)
        U0 = np.abs(rng.randn(64, 4))
        V0 = np.abs(rng.randn(48, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="mu", max_iter=30, tol=0.0)
        m16 = CMF(data_dtype="bfloat16", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m8 = CMF(data_dtype="fp8", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        # same trajectory shape; small-m quantization noise bounds the gap
        assert m8.reconstruction_err_ == pytest.approx(
            m16.reconstruction_err_, rel=0.08)
        hist = m8.loss_history_
        assert hist[-1] < hist[0]

    def test_newton_fit_converges(self, rng):
        X, Y = make_problem(rng, n=64, m=48, binary_y=True)
        m8 = CMF(n_components=4, solver="newton", y_link="sigmoid",
                 data_dtype="fp8", max_iter=8, tol=0.0,
                 random_state=0).fit(X, Y)
        hist = m8.loss_history_
        assert hist[-1] < hist[0]
        assert np.all(np.isfinite(m8.U_))

    def test_fp8_rejected_as_factor_dtype(self, rng):
        X, Y = make_problem(rng)
        with pytest.raises(ValueError, match="data storage dtype"):
            CMF(n_components=4, dtype="fp8", max_iter=2).fit(X, Y)

    def test_fp8_rejected_for_csr_storage(self, rng):
        X, Y = make_problem(rng, sparse=True)
        with pytest.raises(ValueError, match="dense device storage"):
            CMF(n_components=4, data_dtype="fp8", sparse_mode="csr",
                max_iter=2).fit(X, Y)

    def test_fp8_auto_densify_ok(self, rng):
        # sparse input below the densify threshold is fine: it lands dense
        X, Y = make_problem(rng, sparse=True)
        m = CMF(n_components=4, data_dtype="fp8", sparse_mode="auto",
                max_iter=5, tol=0.0, random_state=0).fit(X, Y)
        assert m.loss_history_[-1] < m.loss_history_[0]


class TestFp8Sharded:
    """fp8 data shards on every layout: each chip stores its dense X
    shard/cell at 1 byte/elt (host-densified, converted host-side);
    Y stays bf16; factors/masks/norms stay f32 — the same contract as
    the single-chip fp8 path, so the two fits quantize identically and
    differ only in f32 summation order."""

    def _factors(self, rng, n, m, r, k=4):
        return (np.abs(rng.randn(n, k)), np.abs(rng.randn(m, k)),
                np.abs(rng.randn(r, k)))

    @pytest.mark.parametrize("layout,shards", [
        ("rows", 8), ("cols", 8), ("grid", (2, 4))])
    def test_mu_matches_single_chip_fp8(self, rng, layout, shards):
        X, Y = make_problem(rng, n=64, m=48)
        U0, V0, Z0 = self._factors(rng, 64, 48, Y.shape[1])
        kw = dict(n_components=4, solver="mu", data_dtype="fp8",
                  max_iter=15, tol=0.0, random_state=0)
        m1 = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(n_shards=shards, shard_layout=layout, **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        assert ms.reconstruction_err_ == pytest.approx(
            m1.reconstruction_err_, rel=2e-3)
        assert np.allclose(ms.U_, m1.U_, rtol=2e-2, atol=1e-4)

    def test_newton_sigmoid_y_sharded_fp8(self, rng):
        X, Y = make_problem(rng, n=64, m=48, binary_y=True)
        m = CMF(n_components=4, solver="newton", y_link="sigmoid",
                data_dtype="fp8", n_shards=8, max_iter=6, tol=0.0,
                random_state=0).fit(X, Y)
        assert m.loss_history_[-1] < m.loss_history_[0]
        assert np.all(np.isfinite(m.U_))

    def test_sparse_auto_densifies_per_shard(self, rng):
        # below the per-shard threshold a sparse X lands as dense fp8
        # shards (host densify + 1-byte upload), mirroring single-chip
        X, Y = make_problem(rng, sparse=True)
        m = CMF(n_components=4, data_dtype="fp8", sparse_mode="auto",
                n_shards=8, max_iter=5, tol=0.0, random_state=0).fit(X, Y)
        assert m.loss_history_[-1] < m.loss_history_[0]

    def test_sparse_csr_sharded_raises(self, rng):
        X, Y = make_problem(rng, sparse=True)
        with pytest.raises(ValueError, match="dense device"):
            CMF(n_components=4, data_dtype="fp8", sparse_mode="csr",
                n_shards=8, max_iter=2).fit(X, Y)

    def test_range_guard_sharded(self, rng):
        X, Y = make_problem(rng, n=64, m=48)
        X = X.copy()
        X[3, 4] = 1000.0  # past e4m3's ~±448 range: converts to NaN
        with pytest.raises(ValueError, match="range"):
            CMF(n_components=4, data_dtype="fp8", n_shards=8,
                max_iter=2).fit(X, Y)

    def test_sharded_transform_matches_single(self, rng):
        X, Y = make_problem(rng, n=64, m=48)
        m = CMF(n_components=4, data_dtype="fp8", max_iter=10, tol=0.0,
                random_state=0).fit(X, Y)
        Xn = np.abs(rng.randn(24, 48))
        U_single = m.transform(Xn)
        m.n_shards = 8
        U_sharded = m.transform(Xn)
        assert np.allclose(U_single, U_sharded, rtol=1e-3, atol=1e-5)


class TestFp8Range:
    def test_out_of_range_data_rejected(self, rng):
        from pycmf_tpu.utils.validation import as_coupled

        A = np.abs(rng.randn(16, 16)) + 1.0
        A[3, 4] = 1000.0  # e4m3 overflow converts to NaN, not saturate
        with pytest.raises(ValueError, match="range"):
            as_coupled(A, jnp.float8_e4m3fn)
        import scipy.sparse as sp

        with pytest.raises(ValueError, match="range"):
            as_coupled(sp.csr_matrix(A), jnp.float8_e4m3fn,
                       sparse_mode="dense")

    def test_in_range_data_accepted(self, rng):
        from pycmf_tpu.utils.validation import as_coupled

        A = np.abs(rng.randn(16, 16))
        c = as_coupled(A, jnp.float8_e4m3fn)
        assert c.A.dtype == jnp.float8_e4m3fn

    def test_fp8_allows_csr_y_and_sigmoid_newton_x(self, rng):
        """fp8 only governs X's dense storage: a CSR-staying Y (stored
        bf16) and a Newton-sigmoid sparse X (force-densified) are fine."""
        import scipy.sparse as sp

        X, Y = make_problem(rng, n=48, m=40)
        Ys = sp.csr_matrix(np.where(Y > np.median(Y), Y, 0.0))
        m = CMF(n_components=4, data_dtype="fp8", sparse_mode="csr",
                max_iter=4, tol=0.0, random_state=0).fit(X, Ys)
        assert np.isfinite(m.reconstruction_err_)

        Xs = sp.csr_matrix((X > np.median(X)).astype(float))
        m2 = CMF(n_components=4, solver="newton", x_link="sigmoid",
                 data_dtype="fp8", sparse_mode="csr", max_iter=3, tol=0.0,
                 U_non_negative=False, V_non_negative=False,
                 Z_non_negative=False, random_state=0)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            m2.fit(Xs, Y)
        assert np.isfinite(m2.reconstruction_err_)

    def test_transform_fp8_csr_raises_cleanly(self, rng):
        """transform() routes through as_coupled's storage-layer guard:
        fp8 + CSR-resolving input gets the clean ValueError fit gives,
        not a TypePromotionError deep in spmm (review finding)."""
        import scipy.sparse as sp

        X, Y = make_problem(rng, n=48, m=40)
        m = CMF(n_components=4, data_dtype="fp8", sparse_mode="csr",
                max_iter=3, tol=0.0, random_state=0).fit(X, Y)
        with pytest.raises(ValueError, match="dense device form"):
            m.transform(sp.csr_matrix(X[:10]))

    def test_bad_n_shards_string_raises(self, rng):
        X, Y = make_problem(rng)
        with pytest.raises(ValueError, match="n_shards"):
            CMF(n_components=4, n_shards="All2", max_iter=2).fit(X, Y)
        # case-insensitive 'all' is accepted
        m = CMF(n_components=4, n_shards="ALL", max_iter=2, tol=0.0,
                random_state=0).fit(X, Y)
        assert np.isfinite(m.reconstruction_err_)
