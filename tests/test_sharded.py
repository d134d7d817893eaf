"""Multi-chip tests on 8 virtual CPU devices (SURVEY.md §4d): the sharded
solvers must match the single-device path to float64 tolerance — the psum of
shared-V terms is mathematically the same sum, just reduced over the mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycmf_tpu import CMF
from tests.conftest import make_problem

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _fit_pair(X, Y, rng, solver="mu", layout="rows", n_shards=8, k=4,
              max_iter=30, **kw):
    U0 = np.abs(rng.randn(X.shape[0], k))
    V0 = np.abs(rng.randn(X.shape[1], k))
    Z0 = np.abs(rng.randn(Y.shape[1], k)) if Y is not None else None
    common = dict(n_components=k, solver=solver, max_iter=max_iter, tol=0.0,
                  dtype="float64", **kw)
    m1 = CMF(**common)
    m1.fit(X, Y, U=U0, V=V0, Z=Z0)
    m2 = CMF(n_shards=n_shards, shard_layout=layout, **common)
    m2.fit(X, Y, U=U0, V=V0, Z=Z0)
    return m1, m2


class TestRowsLayout:
    def test_mu_dense_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=67, m=40)  # n not divisible by 8
        m1, m2 = _fit_pair(X, Y, rng)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.Z_, m2.Z_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-9)

    def test_mu_sparse_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=67, m=40, sparse=True)
        m1, m2 = _fit_pair(X, Y, rng, sparse_mode="csr")
        assert np.allclose(m1.U_, m2.U_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-9)

    def test_newton_linear_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=67, m=40)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", max_iter=10)
        # Newton U-updates are row-local, so factors must agree exactly up
        # to reduction order; line-search decisions could only diverge at
        # exact ties, which noise data doesn't produce.
        assert np.allclose(m1.U_, m2.U_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-8)

    def test_newton_sigmoid_y_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=67, m=40, non_negative=False,
                            binary_y=True)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", max_iter=8,
                           y_link="sigmoid", U_non_negative=False,
                           V_non_negative=False, Z_non_negative=False)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.Z_, m2.Z_, rtol=1e-7, atol=1e-9)

    def test_newton_sigmoid_x_padded_rows_masked(self, rng):
        """Sigmoid x_link with n % 8 != 0 exercises the padding row masks:
        without them σ(0)=0.5 phantom rows corrupt V and the loss."""
        X, Y = make_problem(rng, n=61, m=24, non_negative=False)
        X = (X > np.median(X)).astype(float)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", max_iter=6,
                           x_link="sigmoid", U_non_negative=False,
                           V_non_negative=False, Z_non_negative=False)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-8)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-6, atol=1e-8)

    def test_newton_sparse_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=67, m=40, sparse=True)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", max_iter=8,
                           sparse_mode="csr")
        assert np.allclose(m1.U_, m2.U_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-7, atol=1e-9)

    def test_sparse_Y_matches_single_device(self, rng):
        """Replicated CSR Y in the rows layout (Yt spmm path)."""
        import scipy.sparse as sp

        X, Y = make_problem(rng, n=67, m=40)
        Yd = Y.copy()
        Yd[Yd < np.quantile(Yd, 0.6)] = 0.0
        Ys = sp.csr_matrix(Yd)
        U0 = np.abs(rng.randn(X.shape[0], 4))
        V0 = np.abs(rng.randn(X.shape[1], 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="mu", max_iter=20, tol=0.0,
                  dtype="float64", sparse_mode="csr")
        m1 = CMF(**kw).fit(X, Ys, U=U0, V=V0, Z=Z0)
        m2 = CMF(n_shards=8, **kw).fit(X, Ys, U=U0, V=V0, Z=Z0)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-8, atol=1e-10)


class TestColsLayout:
    def test_mu_dense_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=40, m=67)  # m not divisible by 8
        m1, m2 = _fit_pair(X, Y, rng, layout="cols")
        assert np.allclose(m1.U_, m2.U_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-9)

    def test_mu_sparse_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=40, m=67, sparse=True)
        m1, m2 = _fit_pair(X, Y, rng, layout="cols", sparse_mode="csr")
        assert np.allclose(m1.U_, m2.U_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-8, atol=1e-10)

    def test_newton_linear_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=40, m=67)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", layout="cols",
                           max_iter=8)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-8)

    def test_newton_sigmoid_y_padded_matches_single_device(self, rng):
        """m % 8 != 0 with sigmoid Y exercises the shared-dim padding masks
        in the cols layout (Y rows and V rows are padded)."""
        X, Y = make_problem(rng, n=40, m=61, non_negative=False,
                            binary_y=True)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", layout="cols",
                           max_iter=6, y_link="sigmoid",
                           U_non_negative=False, V_non_negative=False,
                           Z_non_negative=False)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-8)
        assert np.allclose(m1.Z_, m2.Z_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-6, atol=1e-8)

    def test_newton_sigmoid_x_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=24, m=61, non_negative=False)
        X = (X > np.median(X)).astype(float)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", layout="cols",
                           max_iter=5, x_link="sigmoid",
                           U_non_negative=False, V_non_negative=False,
                           Z_non_negative=False)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-8)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-6, atol=1e-8)

    def test_newton_sparse_matches_single_device(self, rng):
        X, Y = make_problem(rng, n=40, m=67, sparse=True)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", layout="cols",
                           max_iter=6, sparse_mode="csr")
        assert np.allclose(m1.U_, m2.U_, rtol=1e-7, atol=1e-9)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-7, atol=1e-9)


class TestColsAuxLoss:
    """Cols-layout zero-extra-pass eval loss (_aux_loss_cols): eval-point
    losses come from the step's own (X_locᵀU, UᵀU) pair, so after the
    initial L0 the full `_loss_cols` — the only code path that re-streams
    X — must never run again. Trajectory parity with the single-chip fit
    is asserted by TestColsLayout (those fits take this path)."""

    def _count_loss_cols(self, monkeypatch):
        import pycmf_tpu.parallel.sharded as sh

        calls = []
        orig = sh._loss_cols

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(sh, "_loss_cols", spy)
        return calls

    @pytest.mark.parametrize("solver", ["mu", "newton"])
    def test_no_extra_x_pass_at_eval_points(self, rng, solver,
                                            monkeypatch):
        calls = self._count_loss_cols(monkeypatch)
        X, Y = make_problem(rng, n=40, m=67)
        _fit_pair(X, Y, rng, solver=solver, layout="cols", max_iter=20,
                  eval_every=5)
        # traced exactly once: the initial L0 (run_solver_loop's
        # initial_loss_fn); every eval-point loss comes from the aux pair
        assert len(calls) == 1

    def test_sigmoid_x_uses_phi_aux(self, rng, monkeypatch):
        """Round 5 (VERDICT r04 #2): a sigmoid x_link no longer re-streams
        X at eval points — the V update's accepted-candidate Σφ IS the
        eval loss (φ-aux), so `_loss_cols` runs exactly once (L0).
        Trajectory parity with the single-chip fit is asserted by
        TestColsLayout::test_newton_sigmoid_x_matches_single_device."""
        calls = self._count_loss_cols(monkeypatch)
        X, Y = make_problem(rng, n=24, m=61, non_negative=False)
        X = (X > np.median(X)).astype(float)
        m1, m2 = _fit_pair(X, Y, rng, solver="newton", layout="cols",
                           max_iter=10, eval_every=5, x_link="sigmoid",
                           U_non_negative=False, V_non_negative=False,
                           Z_non_negative=False)
        assert len(calls) == 1   # the initial L0 only
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-8)

    def test_sampled_newton_disqualifies_aux(self, rng, monkeypatch):
        """A sampled V term's (DB, BtB) — or its φ — describe the
        subsample, not the data: stochastic Newton must keep the exact
        eval loss (both aux kinds gate off)."""
        calls = self._count_loss_cols(monkeypatch)
        X, Y = make_problem(rng, n=40, m=67)
        _fit_pair(X, Y, rng, solver="newton", layout="cols", max_iter=10,
                  eval_every=5, sg_sample_ratio=0.5, random_state=0)
        assert len(calls) >= 2

    def test_sampled_sigmoid_newton_disqualifies_phi_aux(self, rng,
                                                         monkeypatch):
        calls = self._count_loss_cols(monkeypatch)
        X, Y = make_problem(rng, n=24, m=61, non_negative=False)
        X = (X > np.median(X)).astype(float)
        _fit_pair(X, Y, rng, solver="newton", layout="cols", max_iter=10,
                  eval_every=5, x_link="sigmoid", sg_sample_ratio=0.5,
                  random_state=0, U_non_negative=False,
                  V_non_negative=False, Z_non_negative=False)
        assert len(calls) >= 2

    @pytest.mark.parametrize("solver", ["mu", "newton"])
    def test_aux_matches_full_loss_at_state(self, rng, solver):
        """_aux_loss_cols evaluated at a fit's final state must equal the
        exact residual loss of the returned factors (f64)."""
        X, Y = make_problem(rng, n=40, m=67)
        _, m2 = _fit_pair(X, Y, rng, solver=solver, layout="cols",
                          max_iter=12, eval_every=3)
        R = np.asarray(X) - m2.U_ @ m2.V_.T
        RY = np.asarray(Y) - m2.V_ @ m2.Z_.T
        exact = 0.5 * ((R * R).sum() + (RY * RY).sum())
        assert m2.loss_history_[-1] == pytest.approx(exact, rel=1e-10)

    def test_device_loop_aux_matches_host(self, rng):
        """Both loops ride the aux loss; histories must agree to f64."""
        X, Y = make_problem(rng, n=40, m=67)
        U0 = np.abs(rng.randn(40, 4))
        V0 = np.abs(rng.randn(67, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="newton", max_iter=12, tol=1e-6,
                  eval_every=3, dtype="float64", n_shards=8,
                  shard_layout="cols")
        m1 = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert m1.n_iter_ == m2.n_iter_
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-12)


class TestShardedDeviceLoop:
    """The in-shard_map device loop must match the host-loop sharded run."""

    def test_mu_rows_device_matches_host(self, rng):
        X, Y = make_problem(rng, n=67, m=40, sparse=True)
        U0 = np.abs(rng.randn(X.shape[0], 4))
        V0 = np.abs(rng.randn(X.shape[1], 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="mu", max_iter=40, tol=1e-5,
                  dtype="float64", n_shards=8, sparse_mode="csr")
        m1 = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert m1.n_iter_ == m2.n_iter_
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-12)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-12)

    def test_newton_rows_device_matches_host(self, rng):
        X, Y = make_problem(rng, n=67, m=40)
        U0 = np.abs(rng.randn(X.shape[0], 4))
        V0 = np.abs(rng.randn(X.shape[1], 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="newton", max_iter=10, tol=1e-6,
                  dtype="float64", n_shards=8, random_state=0)
        m1 = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert m1.n_iter_ == m2.n_iter_
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-12)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-12)
        assert np.allclose(m1.Z_, m2.Z_, rtol=1e-12)

    def test_newton_rows_sampled_device_matches_host(self, rng):
        """sg_sample_ratio < 1: host and device loops must draw the SAME
        per-iteration sampling keys (fold_in on the absolute iteration), so
        stochastic trajectories match too — this is where a silent RNG
        divergence would hide."""
        X, Y = make_problem(rng, n=67, m=40)
        U0 = np.abs(rng.randn(X.shape[0], 4))
        V0 = np.abs(rng.randn(X.shape[1], 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="newton", max_iter=9, tol=0.0,
                  eval_every=4, dtype="float64", n_shards=8, random_state=7,
                  sg_sample_ratio=0.5)
        m1 = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-12)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-12)

    def test_mu_cols_device_matches_host(self, rng):
        X, Y = make_problem(rng, n=40, m=67)
        U0 = np.abs(rng.randn(X.shape[0], 4))
        V0 = np.abs(rng.randn(X.shape[1], 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="mu", max_iter=30, tol=1e-5,
                  dtype="float64", n_shards=8, shard_layout="cols")
        m1 = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert m1.n_iter_ == m2.n_iter_
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-12)

    def test_newton_cols_device_matches_host(self, rng):
        X, Y = make_problem(rng, n=40, m=67, non_negative=False,
                            binary_y=True)
        U0 = rng.randn(X.shape[0], 4)
        V0 = rng.randn(X.shape[1], 4)
        Z0 = rng.randn(Y.shape[1], 4)
        kw = dict(n_components=4, solver="newton", y_link="sigmoid",
                  U_non_negative=False, V_non_negative=False,
                  Z_non_negative=False, n_shards=8, shard_layout="cols",
                  random_state=0, max_iter=8, tol=1e-7, dtype="float64")
        m1 = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert m1.n_iter_ == m2.n_iter_
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-12)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-12)
        assert np.allclose(m1.Z_, m2.Z_, rtol=1e-12)


class TestShardingInfra:
    def test_factors_actually_sharded(self, rng):
        """U must live row-sharded across the mesh during the fit — verify
        via the sharding of the block output, not just final values."""
        from pycmf_tpu.parallel.mesh import make_mesh
        from pycmf_tpu.parallel.sharded import (_prepare_rows,
                                                _shard_specs_rows,
                                                place_operands)

        X, Y = make_problem(rng, n=64, m=40)
        U0 = np.abs(rng.randn(64, 4))
        ops, U_pad, n = _prepare_rows(X, Y, U0, 8, jnp.float64)
        assert U_pad.shape == (64, 4) and n == 64
        assert ops.mask.sum() == 64
        # placed operands: one 8-row block of X per device, Y everywhere
        ops = place_operands(ops, _shard_specs_rows(ops), make_mesh(8))
        shards = ops.X.addressable_shards
        assert len({s.device for s in shards}) == 8
        assert all(s.data.shape == (8, 40) for s in shards)
        assert len(ops.Y.sharding.device_set) == 8

    def test_bad_layout_raises(self, rng):
        X, Y = make_problem(rng)
        with pytest.raises(ValueError, match="layout"):
            CMF(n_components=4, n_shards=8, shard_layout="diag",
                max_iter=2).fit(X, Y)

    def test_too_many_shards_raises(self, rng):
        X, Y = make_problem(rng)
        with pytest.raises(ValueError, match="devices"):
            CMF(n_components=4, n_shards=999, max_iter=2).fit(X, Y)


class TestShardedDataDtype:
    """data_dtype='bfloat16' for sharded fits: shards store X/Y in bf16
    (halving per-device data-pass traffic) while factors/masks/norms
    stay at the factor dtype — same policy as the single-chip path."""

    def _pair(self, rng, layout, solver="mu", max_iter=20):
        X, Y = make_problem(rng, n=67, m=40)
        self._XY = (X, Y)
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(40, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver=solver, max_iter=max_iter,
                  tol=0.0, dtype="float64", data_dtype="bfloat16")
        m1 = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(n_shards=8, shard_layout=layout, **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        mref = CMF(n_components=4, solver=solver, max_iter=max_iter,
                   tol=0.0, dtype="float64").fit(X, Y, U=U0, V=V0, Z=Z0)
        return m1, m2, mref

    @pytest.mark.parametrize("layout", ["rows", "cols"])
    def test_mu_bf16_data_sharded_matches_single(self, rng, layout):
        m1, m2, mref = self._pair(rng, layout)
        # same bf16 quantization of X, but the psum reduction order differs
        # from the single-chip dot at ~1e-7, and each iteration's bf16
        # re-quantization of the evolving V amplifies that discontinuously —
        # ~1e-3 factor divergence after 20 iterations is the expected level
        assert np.allclose(m1.U_, m2.U_, rtol=2e-2, atol=1e-4)
        assert np.allclose(m1.V_, m2.V_, rtol=2e-2, atol=1e-4)
        # and both stay near the full-precision fit
        assert m2.reconstruction_err_ == pytest.approx(
            mref.reconstruction_err_, rel=0.02)

    def test_newton_bf16_data_sharded_converges(self, rng):
        # Newton's rows-layout aux loss reuses the step's bf16 accumulators
        # (zero extra data passes), so at this tiny scale (m=40: no noise
        # averaging) the REPORTED loss carries ±5% quantization noise —
        # judge the FIT by the exact f64 loss of the returned factors
        m1, m2, mref = self._pair(rng, "rows", solver="newton", max_iter=8)
        assert m2.loss_history_[-1] < m2.loss_history_[0]

        X, Y = self._XY   # the data _pair fit on

        def true_loss(mm):
            R = np.asarray(X) - mm.U_ @ mm.V_.T
            RY = np.asarray(Y) - mm.V_ @ mm.Z_.T
            return 0.5 * ((R * R).sum() + (RY * RY).sum())

        # different trajectory after 8 unconverged iterations (bf16 re-
        # quantization of the evolving V flips line-search decisions); the
        # observed gap is ±2% either side of the f64 reference
        assert true_loss(m2) == pytest.approx(true_loss(mref), rel=0.05)



class TestShardedAutoDensify:
    def test_sparse_auto_densifies_per_shard_and_matches_csr(self, rng):
        """sparse_mode='auto' densifies each shard's local block when it
        fits the threshold (the production path for big uniform-sparse
        inputs: shard until local blocks densify); must match the CSR
        sharded path numerically."""
        X, Y = make_problem(rng, n=67, m=40, sparse=True)
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(40, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="mu", max_iter=20, tol=0.0,
                  dtype="float64", n_shards=8)
        m1 = CMF(sparse_mode="csr", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(sparse_mode="auto", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-9)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-8, atol=1e-10)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-8, atol=1e-10)


class TestShardedSampledSparse:
    """Stochastic Newton (sg_sample_ratio < 1) on sharded CSR storage:
    each shard's masked draw (solvers/newton.sample_mask, axis-index
    folded) must reproduce the DENSE-sharded sampled fit exactly —
    gathered sums == masked sums, so the only difference is storage."""

    def _fits(self, rng, layout, n=67, m=40):
        X, Y = make_problem(rng, n=n, m=m, sparse=True)
        U0 = np.abs(rng.randn(n, 4))
        V0 = np.abs(rng.randn(m, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, sg_sample_ratio=0.5,
                  n_shards=8, shard_layout=layout)
        md = CMF(sparse_mode="dense", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(sparse_mode="csr", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        return md, ms

    @pytest.mark.parametrize("layout", ["rows", "cols"])
    def test_csr_sampled_matches_dense_sampled(self, rng, layout):
        md, ms = self._fits(rng, layout)
        assert np.allclose(ms.U_, md.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(ms.V_, md.V_, rtol=1e-9, atol=1e-11)
        assert np.allclose(ms.loss_history_, md.loss_history_, rtol=1e-9)


class TestNShardsAll:
    def test_minus_one_uses_all_devices(self, rng):
        X, Y = make_problem(rng, n=67, m=40)
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(40, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        kw = dict(n_components=4, solver="mu", max_iter=10, tol=0.0,
                  dtype="float64")
        m1 = CMF(n_shards=len(jax.devices()), **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        m2 = CMF(n_shards=-1, **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        m3 = CMF(n_shards="all", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(m1.U_, m2.U_, rtol=1e-12)
        assert np.allclose(m1.U_, m3.U_, rtol=1e-12)


class TestShardedTransform:
    """transform(n_shards>1) routes through the sharded runner (rows
    layout: new X rows + U sharded, V replicated) and must match the
    single-device fold-in exactly — same math, psum-reduced loss."""

    def _fitted(self, rng, solver="mu", **kw):
        X, Y = make_problem(rng, n=40, m=32)
        U0 = np.abs(rng.randn(40, 4))
        V0 = np.abs(rng.randn(32, 4))
        Z0 = np.abs(rng.randn(Y.shape[1], 4))
        m = CMF(n_components=4, solver=solver, max_iter=10, tol=0.0,
                dtype="float64", random_state=0, **kw)
        m.fit(X, Y, U=U0, V=V0, Z=Z0)
        return m

    def test_mu_dense_matches_single_device(self, rng):
        m = self._fitted(rng)
        Xn = np.abs(rng.randn(67, 32))  # 67 not divisible by 8
        U_single = m.transform(Xn)
        m.n_shards = 8
        U_sharded = m.transform(Xn)
        assert U_sharded.shape == (67, 4)
        assert np.allclose(U_single, U_sharded, rtol=1e-8, atol=1e-10)

    def test_mu_sparse_matches_single_device(self, rng):
        import scipy.sparse as sp

        m = self._fitted(rng, sparse_mode="csr")
        Xn = sp.csr_matrix(np.abs(rng.randn(67, 32))
                           * (rng.rand(67, 32) > 0.6))
        U_single = m.transform(Xn)
        m.n_shards = 8
        U_sharded = m.transform(Xn)
        assert np.allclose(U_single, U_sharded, rtol=1e-8, atol=1e-10)

    def test_newton_matches_single_device(self, rng):
        m = self._fitted(rng, solver="newton")
        Xn = np.abs(rng.randn(19, 32))  # fewer rows than 8 shards x 3
        U_single = m.transform(Xn)
        m.n_shards = 8
        U_sharded = m.transform(Xn)
        assert np.allclose(U_single, U_sharded, rtol=1e-7, atol=1e-9)

    def test_external_U0_respected(self, rng):
        m = self._fitted(rng)
        Xn = np.abs(rng.randn(24, 32))
        U0 = np.abs(rng.randn(24, 4))
        U_single = m.transform(Xn, U=U0)
        m.n_shards = 8
        U_sharded = m.transform(Xn, U=U0)
        assert np.allclose(U_single, U_sharded, rtol=1e-8, atol=1e-10)

    def test_fp8_sharded_transform_runs(self, rng):
        # fp8 shards are supported on the fold-in path too (rows layout,
        # dense new rows at 1 byte/elt); parity vs single-chip fp8 is in
        # tests/test_fp8.py::TestFp8Sharded
        m = self._fitted(rng)
        m.dtype = "float32"
        m.data_dtype = "fp8"
        Xn = np.abs(rng.randn(24, 32))
        U_single = m.transform(Xn)
        m.n_shards = 8
        U_sharded = m.transform(Xn)
        assert np.allclose(U_single, U_sharded, rtol=1e-3, atol=1e-5)


class TestGridAuxLoss:
    """Grid-layout zero-extra-pass eval loss (_aux_loss_grid): the aux
    carries the LOCAL ROW-partial (X_cellᵀU, U_locᵀU_loc) pair and only
    eval points psum it — `_loss_grid` (the only code path that
    re-streams X) must run exactly once (the initial L0). Trajectory
    parity vs single-chip is asserted by TestGridLayout."""

    def _count_loss_grid(self, monkeypatch):
        import pycmf_tpu.parallel.grid as gr

        calls = []
        orig = gr._loss_grid

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(gr, "_loss_grid", spy)
        return calls

    @pytest.mark.parametrize("solver", ["mu", "newton"])
    def test_no_extra_x_pass_at_eval_points(self, rng, solver,
                                            monkeypatch):
        calls = self._count_loss_grid(monkeypatch)
        X = np.abs(rng.randn(67, 53))
        Y = np.abs(rng.randn(53, 9))
        CMF(n_components=4, solver=solver, max_iter=20, eval_every=5,
            tol=0.0, dtype="float64", random_state=0, n_shards=(2, 4),
            shard_layout="grid").fit(X, Y)
        assert len(calls) == 1   # L0 only

    def test_sampled_newton_disqualifies_aux(self, rng, monkeypatch):
        calls = self._count_loss_grid(monkeypatch)
        X = np.abs(rng.randn(67, 53))
        Y = np.abs(rng.randn(53, 9))
        CMF(n_components=4, solver="newton", max_iter=10, eval_every=5,
            tol=0.0, dtype="float64", random_state=0, n_shards=(2, 4),
            shard_layout="grid", sg_sample_ratio=0.5).fit(X, Y)
        assert len(calls) >= 2   # L0 + per-eval-block losses

    @pytest.mark.parametrize("solver", ["mu", "newton"])
    def test_aux_matches_full_loss_at_state(self, rng, solver):
        """Reported eval loss (factored, psummed aux) == exact residual
        loss of the returned factors at f64, with penalties."""
        X = np.abs(rng.randn(67, 53))
        Y = np.abs(rng.randn(53, 9))
        m = CMF(n_components=4, solver=solver, max_iter=12, eval_every=3,
                tol=0.0, dtype="float64", random_state=0, alpha=0.05,
                l1_ratio=0.3, n_shards=(2, 4),
                shard_layout="grid").fit(X, Y)

        def pen(M, a=0.05, l1r=0.3):
            return (a * l1r * np.abs(M).sum()
                    + 0.5 * a * (1 - l1r) * (M * M).sum())

        R = X - m.U_ @ m.V_.T
        RY = Y - m.V_ @ m.Z_.T
        exact = (0.5 * ((R * R).sum() + (RY * RY).sum())
                 + pen(m.U_) + pen(m.V_) + pen(m.Z_))
        assert m.loss_history_[-1] == pytest.approx(exact, rel=1e-10)

    def test_device_loop_aux_matches_host(self, rng):
        X = np.abs(rng.randn(67, 53))
        Y = np.abs(rng.randn(53, 9))
        kw = dict(n_components=4, solver="newton", max_iter=12, tol=1e-6,
                  eval_every=3, dtype="float64", random_state=0,
                  n_shards=(2, 4), shard_layout="grid")
        m1 = CMF(loop="host", **kw).fit(X, Y)
        m2 = CMF(loop="device", **kw).fit(X, Y)
        assert m1.n_iter_ == m2.n_iter_
        assert np.allclose(m1.loss_history_, m2.loss_history_, rtol=1e-12)
        assert np.allclose(m1.V_, m2.V_, rtol=1e-12)

    def test_sparse_chunked_grid_aux(self, rng, monkeypatch):
        """Chunked grid cells emit the streamed pair — still zero extra
        passes, and the reported losses match the CSR grid fit."""
        import scipy.sparse as sp

        calls = self._count_loss_grid(monkeypatch)
        Xs = sp.random(67, 53, density=0.2, random_state=1, format="csr")
        Y = np.abs(rng.randn(53, 9))
        kw = dict(n_components=4, solver="mu", max_iter=10, eval_every=5,
                  tol=0.0, dtype="float64", random_state=0,
                  n_shards=(2, 4), shard_layout="grid")
        mc = CMF(sparse_mode="chunked", **kw).fit(Xs, Y)
        n_chunked = len(calls)
        ms = CMF(sparse_mode="csr", **kw).fit(Xs, Y)
        assert n_chunked == 1 and len(calls) == 2   # one L0 per fit
        assert np.allclose(mc.loss_history_, ms.loss_history_, rtol=1e-10)


class TestGridLayout:
    """2-D (rows x cols) mesh: X sharded over both axes, U on rows,
    V on cols, double psum (parallel/grid.py). MU/linear prototype."""

    def _problem(self, rng):
        X = np.abs(rng.randn(67, 53))
        Y = np.abs(rng.randn(53, 9))
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(53, 4))
        Z0 = np.abs(rng.randn(9, 4))
        return X, Y, U0, V0, Z0

    def test_mu_matches_single_device(self, rng):
        X, Y, U0, V0, Z0 = self._problem(rng)
        kw = dict(n_components=4, solver="mu", max_iter=20, tol=0.0,
                  dtype="float64", random_state=0, alpha=0.05,
                  l1_ratio=0.3)
        m1 = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        mg = CMF(n_shards=(2, 4), shard_layout="grid", **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(m1.U_, mg.U_, rtol=1e-10, atol=1e-12)
        assert np.allclose(m1.V_, mg.V_, rtol=1e-10, atol=1e-12)
        assert np.allclose(m1.Z_, mg.Z_, rtol=1e-10, atol=1e-12)
        assert np.allclose(m1.loss_history_, mg.loss_history_, rtol=1e-10)

    def test_int_n_shards_auto_factors(self, rng):
        X, Y, U0, V0, Z0 = self._problem(rng)
        kw = dict(n_components=4, solver="mu", max_iter=10, tol=0.0,
                  dtype="float64", random_state=0)
        m1 = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        mg = CMF(n_shards=8, shard_layout="grid", **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(m1.U_, mg.U_, rtol=1e-10, atol=1e-12)

    def test_single_matrix_mode(self, rng):
        X, _, U0, V0, _ = self._problem(rng)
        kw = dict(n_components=4, solver="mu", max_iter=10, tol=0.0,
                  dtype="float64", random_state=0)
        m1 = CMF(**kw).fit(X, None, U=U0, V=V0)
        mg = CMF(n_shards=(4, 2), shard_layout="grid", **kw).fit(
            X, None, U=U0, V=V0)
        assert np.allclose(m1.U_, mg.U_, rtol=1e-10, atol=1e-12)
        assert np.allclose(m1.V_, mg.V_, rtol=1e-10, atol=1e-12)

    def test_tuple_requires_grid_layout(self, rng):
        with pytest.raises(ValueError, match="grid"):
            CMF(n_components=4, n_shards=(2, 4))._resolve_n_shards()

    def test_newton_linear_matches_single_device(self, rng):
        X, Y, U0, V0, Z0 = self._problem(rng)
        kw = dict(n_components=4, solver="newton", max_iter=8, tol=0.0,
                  dtype="float64", random_state=0)
        m1 = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        mg = CMF(n_shards=(2, 4), shard_layout="grid", **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(m1.U_, mg.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(m1.V_, mg.V_, rtol=1e-9, atol=1e-11)
        assert np.allclose(m1.loss_history_, mg.loss_history_, rtol=1e-10)

    def test_newton_sigmoid_padded_matches_single_device(self, rng):
        """67 and 53 are both non-divisible by the mesh axes, so the
        sigmoid masks cover real padding on BOTH axes."""
        X, Y, U0, V0, Z0 = self._problem(rng)
        Xb = (X > np.median(X)).astype(float)
        Yb = (Y > np.median(Y)).astype(float)
        kw = dict(n_components=4, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, x_link="sigmoid",
                  y_link="sigmoid", U_non_negative=False,
                  V_non_negative=False, Z_non_negative=False)
        m1 = CMF(**kw).fit(Xb, Yb, U=U0 - 0.5, V=V0 - 0.5, Z=Z0 - 0.5)
        mg = CMF(n_shards=(2, 4), shard_layout="grid", **kw).fit(
            Xb, Yb, U=U0 - 0.5, V=V0 - 0.5, Z=Z0 - 0.5)
        assert np.allclose(m1.U_, mg.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(m1.V_, mg.V_, rtol=1e-9, atol=1e-11)
        assert np.allclose(m1.loss_history_, mg.loss_history_, rtol=1e-10)

    def test_newton_sampled_matches_single_device(self, rng):
        """sg_sample_ratio < 1 on the grid: distributed terms fold the
        axis index into the sample key, so the sharded trajectory is its
        own deterministic stream — assert convergence, not equality."""
        X, Y, U0, V0, Z0 = self._problem(rng)
        kw = dict(n_components=4, solver="newton", max_iter=8, tol=0.0,
                  dtype="float64", random_state=0, sg_sample_ratio=0.6)
        mg = CMF(n_shards=(2, 4), shard_layout="grid", **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        h = np.array(mg.loss_history_)
        assert h[-1] < h[0]
        assert np.all(np.isfinite(h))

    def test_factor_grid(self):
        from pycmf_tpu.parallel.grid import factor_grid

        assert factor_grid(8) == (2, 4)
        assert factor_grid(4) == (2, 2)
        assert factor_grid(6) == (2, 3)
        assert factor_grid(7) == (1, 7)

    def test_device_loop_matches_host(self, rng):
        X, Y, U0, V0, Z0 = self._problem(rng)
        kw = dict(n_components=4, solver="mu", max_iter=20, tol=0.0,
                  dtype="float64", random_state=0, n_shards=(2, 4),
                  shard_layout="grid")
        mh = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        md = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(mh.U_, md.U_, rtol=1e-12)
        assert np.allclose(mh.loss_history_, md.loss_history_, rtol=1e-12)

    def test_newton_device_loop_matches_host(self, rng):
        X, Y, U0, V0, Z0 = self._problem(rng)
        kw = dict(n_components=4, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, n_shards=(2, 4),
                  shard_layout="grid")
        mh = CMF(loop="host", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        md = CMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(mh.U_, md.U_, rtol=1e-12)
        assert np.allclose(mh.V_, md.V_, rtol=1e-12)

    def test_bf16_data_matches_single_device(self, rng):
        X, Y, U0, V0, Z0 = self._problem(rng)
        kw = dict(n_components=4, solver="mu", max_iter=10, tol=0.0,
                  dtype="float32", data_dtype="bfloat16", random_state=0)
        m1 = CMF(**kw).fit(X, Y, U=U0, V=V0, Z=Z0)
        mg = CMF(n_shards=(2, 4), shard_layout="grid", **kw).fit(
            X, Y, U=U0, V=V0, Z=Z0)
        # both quantize the data identically; reduction order differs
        assert np.allclose(m1.U_, mg.U_, rtol=5e-3, atol=1e-5)
        assert np.isclose(m1.reconstruction_err_, mg.reconstruction_err_,
                          rtol=1e-3)

    def test_sparse_csr_cells_match_single_device(self, rng):
        """Per-cell CSR grid blocks (+ local transposes) vs single-device
        and vs the dense-cell grid — exact to fp order."""
        import scipy.sparse as sp

        X = np.abs(rng.randn(67, 53))
        Xs = sp.csr_matrix(X * (X > 0.8))
        Y = np.abs(rng.randn(53, 9))
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(53, 4))
        Z0 = np.abs(rng.randn(9, 4))
        kw = dict(n_components=4, solver="mu", max_iter=15, tol=0.0,
                  dtype="float64", random_state=0)
        g = CMF(n_shards=(2, 4), shard_layout="grid", sparse_mode="csr",
                **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(**kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(g.U_, s.U_, rtol=1e-10, atol=1e-12)
        assert np.allclose(g.V_, s.V_, rtol=1e-10, atol=1e-12)
        assert np.allclose(g.loss_history_, s.loss_history_, rtol=1e-10)

    def test_sparse_newton_csr_cells_match(self, rng):
        import scipy.sparse as sp

        X = np.abs(rng.randn(67, 53))
        Xs = sp.csr_matrix(X * (X > 0.8))
        Y = np.abs(rng.randn(53, 9))
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(53, 4))
        Z0 = np.abs(rng.randn(9, 4))
        kw = dict(n_components=4, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0)
        g = CMF(n_shards=(2, 4), shard_layout="grid", sparse_mode="csr",
                **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(**kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(g.U_, s.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(g.V_, s.V_, rtol=1e-9, atol=1e-11)

    def test_sparse_csr_cells_device_loop(self, rng):
        import scipy.sparse as sp

        X = np.abs(rng.randn(67, 53))
        Xs = sp.csr_matrix(X * (X > 0.8))
        Y = np.abs(rng.randn(53, 9))
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(53, 4))
        Z0 = np.abs(rng.randn(9, 4))
        kw = dict(n_components=4, solver="mu", max_iter=10, tol=0.0,
                  dtype="float64", random_state=0, n_shards=(2, 4),
                  shard_layout="grid", sparse_mode="csr")
        mh = CMF(loop="host", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        md = CMF(loop="device", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(mh.U_, md.U_, rtol=1e-12)

    def _sparse_problem(self, rng):
        import scipy.sparse as sp

        X = np.abs(rng.randn(67, 53))
        Xs = sp.csr_matrix(X * (X > 0.8))
        Y = np.abs(rng.randn(53, 9))
        U0 = np.abs(rng.randn(67, 4))
        V0 = np.abs(rng.randn(53, 4))
        Z0 = np.abs(rng.randn(9, 4))
        return Xs, Y, U0, V0, Z0

    def test_sparse_chunked_cells_match_single_device(self, rng):
        """Streamed chunked-COO grid cells (both directions row-chunked)
        vs the single-device fit — the scattered-sparse fast path at
        2-D-mesh scale."""
        Xs, Y, U0, V0, Z0 = self._sparse_problem(rng)
        kw = dict(n_components=4, solver="mu", max_iter=15, tol=0.0,
                  dtype="float64", random_state=0)
        g = CMF(n_shards=(2, 4), shard_layout="grid",
                sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(**kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(g.U_, s.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(g.V_, s.V_, rtol=1e-9, atol=1e-11)
        assert np.allclose(g.loss_history_, s.loss_history_, rtol=1e-9)

    def test_sparse_chunked_newton_cells_match(self, rng):
        Xs, Y, U0, V0, Z0 = self._sparse_problem(rng)
        kw = dict(n_components=4, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0)
        g = CMF(n_shards=(2, 4), shard_layout="grid",
                sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(sparse_mode="dense", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(g.U_, s.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(g.V_, s.V_, rtol=1e-9, atol=1e-11)

    def test_sparse_chunked_cells_device_loop(self, rng):
        Xs, Y, U0, V0, Z0 = self._sparse_problem(rng)
        kw = dict(n_components=4, solver="mu", max_iter=10, tol=0.0,
                  dtype="float64", random_state=0, n_shards=(2, 4),
                  shard_layout="grid", sparse_mode="chunked")
        mh = CMF(loop="host", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        md = CMF(loop="device", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(mh.U_, md.U_, rtol=1e-12)
        assert np.allclose(mh.loss_history_, md.loss_history_, rtol=1e-12)

    def test_grid_auto_streams_over_threshold(self, rng, monkeypatch):
        """'auto' with over-threshold cells and chunked-eligible links
        resolves to the streamed layout (not segment-sum CSR)."""
        import pycmf_tpu.ops.chunked as ck
        import pycmf_tpu.utils.validation as val

        Xs, Y, U0, V0, Z0 = self._sparse_problem(rng)
        calls = []
        real = ck.stack_chunked_grid
        monkeypatch.setattr(
            ck, "stack_chunked_grid",
            lambda *a, **k: (calls.append(1), real(*a, **k))[1])
        monkeypatch.setattr(val, "DENSIFY_THRESHOLD", 64)
        kw = dict(n_components=4, solver="mu", max_iter=5, tol=0.0,
                  dtype="float64", random_state=0)
        g = CMF(n_shards=(2, 4), shard_layout="grid", **kw).fit(
            Xs, Y, U=U0, V=V0, Z=Z0)
        assert calls, "auto did not pick the chunked grid layout"
        s = CMF(sparse_mode="dense", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(g.U_, s.U_, rtol=1e-9, atol=1e-11)

    def test_grid_chunked_sampled_newton_matches_dense(self, rng):
        """Round-4: sampled Newton on chunked grid cells — the per-cell
        draw enters the streamed terms as a mask and must match the
        dense-cell sampled grid fit (same keys, masked == gathered)."""
        Xs, Y, U0, V0, Z0 = self._sparse_problem(rng)
        kw = dict(n_components=4, solver="newton", sg_sample_ratio=0.5,
                  n_shards=(2, 4), shard_layout="grid", max_iter=4,
                  tol=0.0, dtype="float64", random_state=0)
        g = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(sparse_mode="dense", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(g.U_, s.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(g.loss_history_, s.loss_history_, rtol=1e-9)

    def test_grid_sampled_newton_csr_cells_match_dense_cells(
            self, rng, monkeypatch):
        """Over-threshold CSR cells + sg_sample_ratio < 1 run via masked
        sampling (solvers/newton.sample_mask) — the grid-CSR trajectory
        must equal the grid-DENSE trajectory (same per-cell draws,
        gathered sums == masked sums)."""
        import pycmf_tpu.utils.validation as val

        Xs, Y, U0, V0, Z0 = self._sparse_problem(rng)
        kw = dict(n_components=4, solver="newton", sg_sample_ratio=0.5,
                  n_shards=(2, 4), shard_layout="grid", max_iter=6,
                  tol=0.0, dtype="float64", random_state=0)
        md = CMF(sparse_mode="dense", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        monkeypatch.setattr(val, "DENSIFY_THRESHOLD", 64)
        ms = CMF(**kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        assert np.allclose(ms.U_, md.U_, rtol=1e-9, atol=1e-11)
        assert np.allclose(ms.loss_history_, md.loss_history_, rtol=1e-9)
