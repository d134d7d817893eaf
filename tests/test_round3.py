"""Round-3 regression tests: advisor findings + verdict weak items.

Covers:
- n_shards validation rejects silent-disable typos (0, -2, floats, bools)
- streamed_inner matches the direct upcast inner product
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from pycmf_tpu import CMF


class TestNShardsValidation:
    @pytest.mark.parametrize("bad", [0, -2, 2.5, True, False, "some"])
    def test_invalid_raises(self, bad):
        with pytest.raises(ValueError, match="n_shards"):
            CMF(n_components=2, n_shards=bad)._resolve_n_shards()

    def test_valid_passthrough(self):
        assert CMF(n_components=2)._resolve_n_shards() is None
        assert CMF(n_components=2, n_shards=4)._resolve_n_shards() == 4
        assert CMF(n_components=2, n_shards=np.int64(3)
                   )._resolve_n_shards() == 3

    def test_all_and_minus_one(self):
        import jax

        nd = len(jax.devices())
        assert CMF(n_components=2, n_shards=-1)._resolve_n_shards() == nd
        assert CMF(n_components=2, n_shards="all")._resolve_n_shards() == nd


class TestStreamedInner:
    @pytest.mark.parametrize("data_dt", [jnp.float32, jnp.bfloat16])
    def test_matches_direct(self, data_dt):
        from pycmf_tpu.ops.losses import streamed_inner

        rng = np.random.RandomState(2)
        A = rng.rand(70, 50)
        M = rng.rand(70, 6).astype(np.float32)
        B = rng.rand(50, 6).astype(np.float32)
        Ad = jnp.asarray(A, data_dt)
        got = float(streamed_inner(Ad, jnp.asarray(M), jnp.asarray(B)))
        want = float(np.sum((np.asarray(Ad.astype(jnp.float32)) @ B) * M))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_streams_when_large(self, monkeypatch):
        """Force the scan path and check it equals the one-shot path."""
        from pycmf_tpu.ops import losses

        rng = np.random.RandomState(3)
        A = jnp.asarray(rng.rand(64, 40), jnp.bfloat16)
        M = jnp.asarray(rng.rand(64, 4), jnp.float32)
        B = jnp.asarray(rng.rand(40, 4), jnp.float32)
        whole = float(losses.streamed_inner(A, M, B))
        monkeypatch.setattr(losses, "_BLOCK_ELEMS", 40 * 16)
        blocked = float(losses.streamed_inner(A, M, B))
        np.testing.assert_allclose(blocked, whole, rtol=1e-5)


class TestSklearnPipelineCompat:
    def test_get_feature_names_out(self, rng):
        X = np.abs(rng.rand(40, 30))
        m = CMF(n_components=3, max_iter=5, random_state=0).fit(X)
        assert list(m.get_feature_names_out()) == ["cmf0", "cmf1", "cmf2"]

    def test_unfitted_raises(self):
        with pytest.raises(AttributeError):
            CMF(n_components=3).get_feature_names_out()

    def test_pipeline_transform_chain(self, rng):
        from sklearn.pipeline import Pipeline

        X = np.abs(rng.rand(40, 30))
        p = Pipeline([("cmf", CMF(n_components=3, max_iter=5,
                                  random_state=0))])
        p.fit(X)
        U = p.transform(X)
        assert U.shape == (40, 3)


class TestReviewFixes:
    """Round-3 self-review findings (code-review pass over the diff)."""

    def test_newton_chunked_sparse_y_works(self, rng):
        """Y must never resolve to the chunked layout (it has no .T and
        the Z update reads Y.A.T); forced 'chunked' maps to 'auto' for Y."""
        X = sp.csr_matrix(np.abs(rng.randn(80, 60))
                          * (rng.rand(80, 60) > 0.8))
        Ys = sp.csr_matrix(np.abs(rng.randn(60, 6))
                           * (rng.rand(60, 6) > 0.5))
        m = CMF(n_components=4, solver="newton", sparse_mode="chunked",
                max_iter=3, random_state=0).fit(X, Ys)
        assert np.isfinite(m.reconstruction_err_)
        m2 = CMF(n_components=4, solver="mu", sparse_mode="chunked",
                 max_iter=3, random_state=0).fit(X, Ys)
        assert np.isfinite(m2.reconstruction_err_)

    def test_chunked_true_nnz(self, rng):
        from pycmf_tpu.ops.chunked import chunked_from_scipy

        X = sp.csr_matrix(np.abs(rng.randn(64, 32))
                          * (rng.rand(64, 32) > 0.9))
        C = chunked_from_scipy(X, dtype=jnp.float64, chunk_rows=16)
        assert C.nnz == X.nnz
        assert C.capacity >= C.nnz

    def test_chunked_padding_skew_warns(self):
        """One heavy chunk padding every other chunk triggers the guard."""
        from pycmf_tpu.ops.chunked import chunked_from_scipy

        rows = np.concatenate([np.zeros(500, np.int32),
                               np.arange(1, 64, dtype=np.int32)])
        cols = np.concatenate([np.arange(500, dtype=np.int32) % 600,
                               np.zeros(63, np.int32)])
        vals = np.ones(563)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(64, 600))
        with pytest.warns(UserWarning, match="padding"):
            chunked_from_scipy(A, dtype=jnp.float64, chunk_rows=8)

    def test_stack_chunked_stays_on_host_until_upload(self, rng):
        from pycmf_tpu.ops.chunked import chunked_from_scipy

        X = sp.csr_matrix(np.abs(rng.randn(40, 30))
                          * (rng.rand(40, 30) > 0.8))
        host = chunked_from_scipy(X, dtype=jnp.float32, chunk_rows=16,
                                  return_numpy=True)
        assert isinstance(host.data, np.ndarray)
        assert isinstance(host.cols, np.ndarray)
        dev = chunked_from_scipy(X, dtype=jnp.float32, chunk_rows=16)
        np.testing.assert_allclose(host.data, np.asarray(dev.data))

    def test_grid_sampled_newton_sparse_x_accepted(self, rng):
        """_stays_sparse must not falsely reject grid configs: the grid
        runner densifies, so sampled Newton on sparse linear X is valid."""
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        X = sp.csr_matrix(np.abs(rng.randn(40, 30))
                          * (rng.rand(40, 30) > 0.7))
        Y = np.abs(rng.randn(30, 5))
        m = CMF(n_components=3, solver="newton", shard_layout="grid",
                n_shards=(2, 2), sg_sample_ratio=0.5, max_iter=3,
                random_state=0).fit(X, Y)
        assert np.isfinite(m.reconstruction_err_)


class TestEpsZeroShardedParity:
    """Round-3 review finding: every sharded layout NaN'd at
    eps=0, alpha=0 — the zero-padding rows' ratio update is 0·0/0 = NaN
    without the l1/ε guard, and one NaN row poisons every psummed term
    (0·NaN = NaN). The fix forces padding rows to exact zeros after each
    MU ratio update (and in-pass for the chunked stream); the
    single-device fit (no padding) is the parity reference."""

    def _problem(self, rng):
        X = np.abs(rng.randn(67, 53)) + 0.01
        Y = np.abs(rng.randn(53, 9))
        Xs = sp.csr_matrix(X * (X > 0.8))
        return X, Xs, Y

    @pytest.fixture
    def rng(self):
        return np.random.RandomState(7)

    @pytest.mark.parametrize("kw", [
        dict(n_shards=8),
        dict(n_shards=8, shard_layout="cols"),
        dict(n_shards=(2, 4), shard_layout="grid"),
    ], ids=["rows", "cols", "grid"])
    def test_dense_layouts_match_single(self, rng, kw):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        X, _, Y = self._problem(rng)
        base = dict(n_components=4, solver="mu", max_iter=8, tol=0.0,
                    dtype="float64", random_state=0, eps=0.0, alpha=0.0)
        s = CMF(**base).fit(X, Y)
        m = CMF(**base, **kw).fit(X, Y)
        assert np.all(np.isfinite(m.U_))
        assert np.allclose(m.U_, s.U_, rtol=1e-10, atol=1e-12)
        assert np.allclose(m.V_, s.V_, rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("kw", [
        dict(n_shards=8, sparse_mode="chunked"),
        dict(n_shards=(2, 4), shard_layout="grid", sparse_mode="csr"),
    ], ids=["rows-chunked", "grid-csr"])
    def test_sparse_layouts_finite(self, rng, kw):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        _, Xs, Y = self._problem(rng)
        base = dict(n_components=4, solver="mu", max_iter=8, tol=0.0,
                    dtype="float64", random_state=0, eps=0.0, alpha=0.0)
        m = CMF(**base, **kw).fit(Xs, Y)
        assert np.all(np.isfinite(m.U_)) and np.all(np.isfinite(m.V_))


class TestShardedTransformSparseMode:
    """Round-3 review finding: the sharded transform passed the raw
    sparse_mode kwarg instead of the per-matrix resolution, so a
    sigmoid-x model crashed folding in sparse X where the single-chip
    fold-in (which densifies, like fit does) works."""

    def test_sigmoid_x_sparse_transform_sharded(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        rng = np.random.RandomState(3)
        Xs = sp.csr_matrix((rng.rand(67, 53) < 0.2).astype(float))
        Y = np.abs(rng.randn(53, 9))
        m = CMF(n_components=4, solver="newton", x_link="sigmoid",
                random_state=0, max_iter=4, dtype="float64", n_shards=8,
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False).fit(Xs, Y)
        Xnew = sp.csr_matrix((rng.rand(25, 53) < 0.2).astype(float))
        t_shard = m.transform(Xnew)
        m.n_shards = None
        t_single = m.transform(Xnew)
        assert t_shard.shape == (25, 4)
        assert np.allclose(t_shard, t_single, rtol=1e-9, atol=1e-11)


class TestGridModelTransform:
    """A grid-fit model must still fold in new rows: transform() routes
    through the rows layout with the flattened device count (new rows
    only shard n; V stays replicated), and must match the single-device
    fold-in."""

    def test_grid_fit_then_transform(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        rng = np.random.RandomState(11)
        X = np.abs(rng.randn(67, 53))
        Y = np.abs(rng.randn(53, 9))
        m = CMF(n_components=4, solver="mu", max_iter=6, tol=0.0,
                dtype="float64", random_state=0,
                n_shards=(2, 4), shard_layout="grid").fit(X, Y)
        Xnew = np.abs(rng.randn(21, 53))
        t_grid = m.transform(Xnew)
        m.n_shards = None
        t_single = m.transform(Xnew)
        assert t_grid.shape == (21, 4)
        assert np.allclose(t_grid, t_single, rtol=1e-9, atol=1e-11)


class TestCoreReviewFindings:
    """Round-3 deep review of the core modules (solvers/ops/models)."""

    def test_sharded_sampled_dense_fit_works(self, ):
        """_stays_sparse ignored sparse_mode under 1-D sharding, so a
        sharded sampled-Newton fit with sparse_mode='dense' was rejected
        with an error telling the user to do what they were already
        doing (run_sharded host-densifies exactly this case)."""
        import jax

        if len(jax.devices()) < 2:
            pytest.skip("needs virtual devices")
        rng = np.random.RandomState(0)
        Xs = sp.csr_matrix(np.abs(rng.randn(67, 53))
                           * (rng.rand(67, 53) > 0.8))
        Y = np.abs(rng.randn(53, 9))
        m = CMF(n_components=4, solver="newton", sg_sample_ratio=0.5,
                n_shards=2, shard_layout="rows", sparse_mode="dense",
                random_state=0, max_iter=3).fit(Xs, Y)
        assert np.isfinite(m.reconstruction_err_)
        # 'auto' under the threshold densifies the local shard too
        m2 = CMF(n_components=4, solver="newton", sg_sample_ratio=0.5,
                 n_shards=2, shard_layout="rows", sparse_mode="auto",
                 random_state=0, max_iter=3).fit(Xs, Y)
        assert np.isfinite(m2.reconstruction_err_)

    def test_bf16_factor_dtype_rejected(self):
        with pytest.raises(ValueError, match="data_dtype"):
            CMF(n_components=2, dtype="bfloat16").fit(
                np.abs(np.random.RandomState(0).randn(10, 8)))

    def test_csr_astype_keeps_sq_norm_precision(self):
        from pycmf_tpu.ops.sparse import csr_from_scipy

        rng = np.random.RandomState(0)
        A = csr_from_scipy(sp.csr_matrix(np.abs(rng.randn(50, 40))),
                           dtype=jnp.float32)
        B = A.astype(jnp.bfloat16)
        assert B.data.dtype == jnp.bfloat16
        assert B.sq_norm.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(B.sq_norm),
                                   np.asarray(A.sq_norm), rtol=1e-7)
