"""Regression tests for the round-2 fixes (VERDICT.md / ADVICE.md items):
device-loop divergence detection, verbose loop resolution, RandomState
seeding, sparse+sigmoid Newton, sampled-sparse rejection, init fallbacks,
bf16 norm dtypes, and indefinite-Hessian solve routing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from pycmf_tpu import CMF
from pycmf_tpu.models.cmf import _jax_seed
from pycmf_tpu.solvers.common import finish_device_fit
from tests.conftest import make_problem


class TestDeviceFitDivergence:
    """ADVICE item 1: NaN padding from early stopping must be distinguished
    from a mid-run divergence — only the latter raises."""

    def _result(self, hist, n_iter):
        k = 3
        U = jnp.ones((4, k))
        return (U, U, U, jnp.asarray(n_iter), jnp.asarray(hist))

    def test_early_stop_nan_padding_is_fine(self):
        # stopped after 2 eval blocks of 5 iters: slots 0..2 written
        hist = [10.0, 5.0, 4.9, np.nan, np.nan]
        U, V, Z, n_iter, losses, iters = finish_device_fit(
            self._result(hist, 10), eval_every=5, max_iter=20)
        assert losses == [10.0, 5.0, 4.9]
        assert iters == [0, 5, 10]

    def test_mid_run_nan_raises(self):
        # ran to max_iter with a NaN loss at the second eval point
        hist = [10.0, 5.0, np.nan, np.nan, np.nan]
        with pytest.raises(FloatingPointError, match="non-finite"):
            finish_device_fit(self._result(hist, 20), eval_every=5,
                              max_iter=20)

    def test_remainder_block_nan_raises(self):
        # max_iter=12, eval_every=5 → 2 full blocks + remainder slot
        hist = [10.0, 5.0, 4.0, np.nan]
        with pytest.raises(FloatingPointError):
            finish_device_fit(self._result(hist, 12), eval_every=5,
                              max_iter=12)

    def test_divergent_device_fit_raises_through_estimator(self, rng):
        """End-to-end: a Newton fit engineered to blow up in float32 must
        raise from the device loop, not return NaN factors silently."""
        X, Y = make_problem(rng, n=24, m=16, non_negative=False)
        m = CMF(n_components=3, solver="newton", loop="device",
                dtype="float32", max_iter=6, tol=0.0, random_state=0,
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, line_search_trials=0,
                hessian_pertubation=0.0, eps=0.0)
        # Huge scale + zero damping + full steps: overflows f32 quickly.
        with pytest.raises(FloatingPointError):
            m.fit(X * 1e30, Y * 1e30)


class TestLoopResolution:
    def test_verbose_auto_falls_back_to_host(self):
        m = CMF(n_components=2, verbose=1, loop="auto")
        assert m._resolve_loop() == "host"

    def test_quiet_auto_resolves_per_backend(self):
        m = CMF(n_components=2, verbose=0, loop="auto")
        expected = "device" if jax.default_backend() == "gpu" else "host"
        assert m._resolve_loop() == expected

    def test_explicit_device_honored_with_verbose(self):
        m = CMF(n_components=2, verbose=1, loop="device")
        assert m._resolve_loop() == "device"


class TestRandomStateSeeding:
    def test_distinct_randomstates_give_distinct_seeds(self):
        s1 = _jax_seed(np.random.RandomState(1))
        s2 = _jax_seed(np.random.RandomState(2))
        assert s1 != s2

    def test_same_seed_randomstates_agree(self):
        assert _jax_seed(np.random.RandomState(3)) == \
            _jax_seed(np.random.RandomState(3))

    def test_int_seed_passthrough(self):
        assert _jax_seed(17) == 17
        assert _jax_seed(None) == 0

    def test_sampled_newton_depends_on_randomstate(self, rng):
        """Two differently-seeded RandomState instances must draw different
        Newton sampling streams (previously both mapped to seed 0)."""
        X, Y = make_problem(rng, n=40, m=30)
        U0 = np.abs(rng.randn(40, 3))
        V0 = np.abs(rng.randn(30, 3))
        Z0 = np.abs(rng.randn(Y.shape[1], 3))
        kw = dict(n_components=3, solver="newton", sg_sample_ratio=0.3,
                  max_iter=3, tol=0.0, dtype="float64")
        m1 = CMF(random_state=np.random.RandomState(1), **kw)
        m2 = CMF(random_state=np.random.RandomState(2), **kw)
        m1.fit(X, Y, U=U0, V=V0, Z=Z0)
        m2.fit(X, Y, U=U0, V=V0, Z=Z0)
        assert not np.allclose(m1.U_, m2.U_)


class TestSparseSigmoidNewton:
    """VERDICT item 7: sparse data + sigmoid link is now supported by
    densifying the sigmoid-linked matrix (the Newton update materializes
    dense sigmoid predictions of the same size anyway)."""

    def test_sparse_sigmoid_y_matches_dense_oracle(self, rng):
        X, Y = make_problem(rng, n=40, m=30, non_negative=False,
                            binary_y=True)
        Ys = sp.csr_matrix(Y)
        U0 = rng.randn(40, 3)
        V0 = rng.randn(30, 3)
        Z0 = rng.randn(Y.shape[1], 3)
        kw = dict(n_components=3, solver="newton", y_link="sigmoid",
                  U_non_negative=False, V_non_negative=False,
                  Z_non_negative=False, max_iter=5, tol=0.0,
                  dtype="float64")
        md = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(**kw).fit(X, Ys, U=U0, V=V0, Z=Z0)
        assert np.allclose(md.Z_, ms.Z_, rtol=1e-12)
        assert np.allclose(md.loss_history_, ms.loss_history_, rtol=1e-12)

    def test_sparse_sigmoid_x_fits(self, rng):
        X, Y = make_problem(rng, n=40, m=30, non_negative=False)
        Xb = sp.csr_matrix((X > np.median(X)).astype(float))
        m = CMF(n_components=3, solver="newton", x_link="sigmoid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, max_iter=4, tol=0.0,
                random_state=0, dtype="float64")
        m.fit(Xb, Y)
        assert m.loss_history_[-1] < m.loss_history_[0]

    def test_csr_mode_override_warns(self, rng):
        X, Y = make_problem(rng, n=30, m=20, non_negative=False,
                            binary_y=True)
        m = CMF(n_components=3, solver="newton", y_link="sigmoid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, sparse_mode="csr", max_iter=2,
                random_state=0, dtype="float64")
        with pytest.warns(UserWarning, match="overridden to 'dense'"):
            m.fit(X, sp.csr_matrix(Y))

    def test_sharded_sparse_sigmoid_y_fits(self, rng):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        X, Y = make_problem(rng, n=41, m=24, non_negative=False,
                            binary_y=True)
        m = CMF(n_components=3, solver="newton", y_link="sigmoid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, n_shards=8, max_iter=3, tol=0.0,
                random_state=0, dtype="float64")
        m.fit(X, sp.csr_matrix(Y))
        assert np.isfinite(m.reconstruction_err_)


class TestSampledSparseRejection:
    """VERDICT item 6 (round 2): no silent full-batch fallback for
    sampled sparse. Round 3 closed the capability instead: CSR/chunked
    terms now run the SAME draw as a 0/1 mask (solvers/newton.
    sample_mask — masked sums == gathered sums, no rescaling), so the
    former rejection is now exact parity with the dense sampled fit."""

    def test_sampled_csr_linear_matches_dense(self, rng):
        X, Y = make_problem(rng, n=40, m=30, sparse=True)
        U0 = np.abs(rng.randn(40, 3))
        V0 = np.abs(rng.randn(30, 3))
        Z0 = np.abs(rng.randn(Y.shape[1], 3))
        kw = dict(n_components=3, solver="newton", sg_sample_ratio=0.5,
                  max_iter=4, tol=0.0, random_state=0, dtype="float64")
        ms = CMF(sparse_mode="csr", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        md = CMF(sparse_mode="dense", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(ms.U_, md.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.loss_history_, md.loss_history_,
                                   rtol=1e-9)

    def test_sampled_auto_densified_works(self, rng):
        X, Y = make_problem(rng, n=40, m=30, sparse=True)
        m = CMF(n_components=3, solver="newton", sg_sample_ratio=0.5,
                sparse_mode="auto", max_iter=3, random_state=0,
                dtype="float64")
        m.fit(X, Y)  # auto densifies below the threshold → sampling fine
        assert np.isfinite(m.reconstruction_err_)

    def test_sampled_sparse_sigmoid_works(self, rng):
        """Sigmoid-linked sparse matrices are densified, so sampling them
        is supported."""
        X, Y = make_problem(rng, n=40, m=30, non_negative=False,
                            binary_y=True)
        m = CMF(n_components=3, solver="newton", y_link="sigmoid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, sg_sample_ratio=0.5, max_iter=3,
                tol=0.0, random_state=0, dtype="float64")
        m.fit(X, sp.csr_matrix(Y))
        assert np.isfinite(m.reconstruction_err_)


class TestInitFallbacks:
    """ADVICE item 3: 'svd' must be honored for unconstrained factors;
    NNDSVD variants must be rejected loudly, not silently replaced."""

    def test_svd_init_unconstrained_keeps_signs(self, rng):
        from pycmf_tpu.utils.init import _init_pair

        A = rng.randn(30, 20)
        W, H = _init_pair(A, 4, "svd", rng, non_negative=False)
        assert (W < 0).any() or (H < 0).any()
        # rank-4 SVD warm start should reconstruct better than random
        r_svd = np.linalg.norm(A - W @ H.T)
        Wr, Hr = _init_pair(A, 4, "random", rng, non_negative=False)
        r_rand = np.linalg.norm(A - Wr @ Hr.T)
        assert r_svd < r_rand

    def test_nndsvd_unconstrained_raises(self, rng):
        X, Y = make_problem(rng, n=30, m=20, non_negative=False)
        m = CMF(n_components=3, solver="newton", x_init="nndsvd",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, max_iter=2)
        with pytest.raises(ValueError, match="NNDSVD"):
            m.fit(X, Y)

    def test_svd_init_estimator_unconstrained(self, rng):
        X, Y = make_problem(rng, n=30, m=20, non_negative=False)
        m = CMF(n_components=3, solver="newton", x_init="svd", y_init="svd",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False, max_iter=3, random_state=0,
                dtype="float64")
        m.fit(X, Y)
        assert np.isfinite(m.reconstruction_err_)


class TestBf16NormDtypes:
    """ADVICE item 4: per-row norms / sq_norm stay f32 under bf16 data."""

    def test_as_coupled_sparse_bf16_row_norms_f32(self, rng):
        from pycmf_tpu.utils.validation import as_coupled

        X = sp.csr_matrix(np.abs(rng.randn(20, 15)) *
                          (rng.rand(20, 15) > 0.5))
        C = as_coupled(X, jnp.bfloat16, sparse_mode="csr")
        assert C.row_sq.dtype == jnp.float32
        assert C.row_sq_t.dtype == jnp.float32
        assert C.A.sq_norm.dtype == jnp.float32
        assert C.A.data.dtype == jnp.bfloat16
