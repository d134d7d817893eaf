"""Streaming chunked-COO sparse path (ops/chunked.py; round-2 VERDICT
item 1): the single-chip answer for scattered-sparse X past the densify
threshold. Oracle = the dense and CSR paths (same math, different layout).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from pycmf_tpu import CMF
from pycmf_tpu.ops.chunked import (ChunkedCoo, chunked_from_scipy,
                                   chunked_inner, chunked_mu_u_pass,
                                   chunked_spmm, chunked_spmm_t, is_chunked,
                                   pick_chunk_rows)


@pytest.fixture
def Xs(rng):
    return sp.csr_matrix(np.abs(rng.randn(137, 90))
                         * (rng.rand(137, 90) > 0.85))


class TestChunkedOps:
    @pytest.mark.parametrize("chunk_rows", [16, 64, 137, 200])
    def test_spmm_matches_scipy(self, rng, Xs, chunk_rows):
        X = chunked_from_scipy(Xs, dtype=jnp.float64, chunk_rows=chunk_rows)
        B = rng.rand(90, 5)
        got = np.asarray(chunked_spmm(X, jnp.asarray(B)))
        np.testing.assert_allclose(got, Xs @ B, rtol=1e-12)

    def test_spmm_t_matches_scipy(self, rng, Xs):
        X = chunked_from_scipy(Xs, dtype=jnp.float64, chunk_rows=32)
        M = rng.rand(137, 5)
        got = np.asarray(chunked_spmm_t(X, jnp.asarray(M)))
        np.testing.assert_allclose(got, Xs.T @ M, rtol=1e-12)

    def test_inner_matches_scipy(self, rng, Xs):
        X = chunked_from_scipy(Xs, dtype=jnp.float64, chunk_rows=50)
        M, B = rng.rand(137, 5), rng.rand(90, 5)
        got = float(chunked_inner(X, jnp.asarray(M), jnp.asarray(B)))
        want = float(np.sum((Xs @ B) * M))
        np.testing.assert_allclose(got, want, rtol=1e-12)

    def test_mu_pass_matches_dense_update(self, rng, Xs):
        X = chunked_from_scipy(Xs, dtype=jnp.float64, chunk_rows=48)
        U = jnp.asarray(np.abs(rng.randn(137, 5)))
        V = jnp.asarray(np.abs(rng.randn(90, 5)))
        VtV = V.T @ V
        U2, numV, gramU = chunked_mu_u_pass(X, U, V, VtV, 0.01, 0.02, 1e-10)
        Xd = np.asarray(Xs.todense())
        U2_want = np.asarray(U) * (Xd @ np.asarray(V)) / (
            np.asarray(U) @ np.asarray(VtV) + 0.01 + 0.02 * np.asarray(U)
            + 1e-10)
        np.testing.assert_allclose(np.asarray(U2), U2_want, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(numV), Xd.T @ U2_want,
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(gramU), U2_want.T @ U2_want,
                                   rtol=1e-10)

    def test_duplicate_coo_entries_summed(self):
        A = sp.coo_matrix((np.array([1.0, 2.0, 4.0]),
                           (np.array([0, 0, 2]), np.array([1, 1, 0]))),
                          shape=(40, 8))
        X = chunked_from_scipy(A, dtype=jnp.float64, chunk_rows=16)
        got = np.asarray(chunked_spmm(X, jnp.eye(8)))
        np.testing.assert_allclose(got, np.asarray(A.todense()))

    def test_pick_chunk_rows(self):
        # small m: capped by multiples of 128 rows
        assert pick_chunk_rows(10_000, 1000, 256 << 20) % 128 == 0
        # huge m: floor 8, multiple of 8
        r = pick_chunk_rows(10_000, 50_000_000, 256 << 20)
        assert r >= 8 and r % 8 == 0

    def test_pytree_roundtrip(self, Xs):
        import jax

        X = chunked_from_scipy(Xs, dtype=jnp.float32, chunk_rows=64)
        leaves, treedef = jax.tree_util.tree_flatten(X)
        X2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert is_chunked(X2) and X2.shape == X.shape
        assert X2.chunk_rows == X.chunk_rows


class TestChunkedEstimator:
    def _fit(self, X, Y, inits, **kw):
        U0, V0, Z0 = inits
        m = CMF(n_components=5, solver="mu", max_iter=25, tol=0.0,
                dtype="float64", random_state=0, **kw)
        m.fit(X, Y, U=U0, V=V0, Z=Z0)
        return m

    def test_fit_matches_dense_exactly(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        inits = (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)),
                 np.abs(rng.randn(6, 5)))
        md = self._fit(Xs, Y, inits, sparse_mode="dense")
        mc = self._fit(Xs, Y, inits, sparse_mode="chunked")
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-10)
        np.testing.assert_allclose(mc.V_, md.V_, rtol=1e-10)
        np.testing.assert_allclose(mc.loss_history_, md.loss_history_,
                                   rtol=1e-12)

    def test_device_loop_matches_host(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        inits = (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)),
                 np.abs(rng.randn(6, 5)))
        mh = self._fit(Xs, Y, inits, sparse_mode="chunked", loop="host")
        md = self._fit(Xs, Y, inits, sparse_mode="chunked", loop="device")
        np.testing.assert_allclose(md.U_, mh.U_, rtol=1e-10)
        np.testing.assert_allclose(md.loss_history_, mh.loss_history_,
                                   rtol=1e-10)

    def test_transform_matches_dense(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        inits = (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)),
                 np.abs(rng.randn(6, 5)))
        md = self._fit(Xs, Y, inits, sparse_mode="dense")
        mc = self._fit(Xs, Y, inits, sparse_mode="chunked")
        Xn = sp.csr_matrix(np.abs(rng.randn(23, 90))
                           * (rng.rand(23, 90) > 0.7))
        np.testing.assert_allclose(mc.transform(Xn), md.transform(Xn),
                                   rtol=1e-10)

    def test_single_matrix_nmf_mode(self, rng, Xs):
        inits = (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)), None)
        md = self._fit(Xs, None, inits, sparse_mode="dense")
        mc = self._fit(Xs, None, inits, sparse_mode="chunked")
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-10)

    def test_loss_decreases(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        m = CMF(n_components=5, solver="mu", max_iter=30, tol=0.0,
                sparse_mode="chunked", random_state=0, dtype="float64")
        m.fit(Xs, Y)
        h = np.array(m.loss_history_)
        assert np.all(np.diff(h) <= 1e-10 * h[0])

    def test_newton_chunked_linear_supported(self, rng, Xs):
        """Round-3 extension: full-batch linear Newton streams chunks
        (TestChunkedNewton has the parity tests); only the sampled
        variant is rejected."""
        Y = np.abs(rng.randn(90, 6))
        m = CMF(n_components=5, solver="newton", sparse_mode="chunked",
                max_iter=3, random_state=0).fit(Xs, Y)
        assert np.isfinite(m.reconstruction_err_)

    def _inits(self, rng):
        return (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)),
                np.abs(rng.randn(6, 5)))

    @pytest.mark.parametrize("layout,shards", [
        ("rows", 4), ("cols", 4), ("grid", (2, 2))])
    def test_sharded_chunked_sampled_matches_dense_sharded(
            self, rng, Xs, layout, shards):
        """Round-4 (VERDICT r03 next #3): stochastic Newton on the
        SHARDED streamed passes — the per-shard draw enters the chunked
        terms as a mask and must reproduce the dense sampled SHARDED fit
        exactly (same keys, masked sums == gathered sums)."""
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 virtual devices")
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=4, tol=0.0,
                  dtype="float64", random_state=0, sg_sample_ratio=0.5,
                  n_shards=shards, shard_layout=layout)
        md = CMF(sparse_mode="dense", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        mc = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0,
                                                  Z=Z0)
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(mc.V_, md.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(mc.loss_history_, md.loss_history_,
                                   rtol=1e-9)

    @pytest.mark.parametrize("layout,shards", [
        ("rows", 4), ("cols", 4), ("grid", (2, 2))])
    def test_sharded_chunked_sampled_sigmoid_matches_dense(
            self, rng, layout, shards):
        """Sampled SIGMOID Newton on sharded chunked X: the streamed
        sigmoid terms take the same per-shard mask."""
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 virtual devices")
        Xb = sp.csr_matrix(
            (rng.rand(90, 64) > 0.8).astype(np.float64))
        Y = np.abs(rng.randn(64, 6))
        U0 = rng.randn(90, 5) * 0.1
        V0 = rng.randn(64, 5) * 0.1
        Z0 = rng.randn(6, 5) * 0.1
        kw = dict(n_components=5, solver="newton", x_link="sigmoid",
                  U_non_negative=False, V_non_negative=False,
                  Z_non_negative=False, max_iter=3, tol=0.0,
                  dtype="float64", random_state=0, sg_sample_ratio=0.5,
                  n_shards=shards, shard_layout=layout)
        md = CMF(sparse_mode="dense", **kw).fit(Xb, Y, U=U0, V=V0, Z=Z0)
        mc = CMF(sparse_mode="chunked", **kw).fit(Xb, Y, U=U0, V=V0,
                                                  Z=Z0)
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(mc.loss_history_, md.loss_history_,
                                   rtol=1e-9)

    def test_fp8_chunked_raises(self, rng, Xs):
        from pycmf_tpu.utils.validation import as_coupled

        with pytest.raises(ValueError, match="fp8"):
            as_coupled(Xs, jnp.float8_e4m3fn, sparse_mode="chunked")

    def test_auto_resolves_chunked_above_threshold(self, rng, Xs):
        from pycmf_tpu.utils.validation import as_coupled

        # tiny threshold forces the beyond-threshold branch
        C = as_coupled(Xs, jnp.float64, sparse_mode="auto",
                       densify_threshold=1024, chunked_ok=True)
        assert is_chunked(C.A)
        C2 = as_coupled(Xs, jnp.float64, sparse_mode="auto",
                        densify_threshold=1024, chunked_ok=False)
        assert not is_chunked(C2.A)

    def test_storage_dtype_threshold(self, rng, Xs):
        """bf16 storage halves the footprint → densifies where f32 won't."""
        from pycmf_tpu.ops.sparse import is_sparse
        from pycmf_tpu.utils.validation import as_coupled

        thr = 137 * 90 * 3  # between bf16 (x2) and f32 (x4) footprints
        Cb = as_coupled(Xs, jnp.bfloat16, sparse_mode="auto",
                        densify_threshold=thr)
        assert not is_sparse(Cb.A) and not is_chunked(Cb.A)
        Cf = as_coupled(Xs, jnp.float32, sparse_mode="auto",
                        densify_threshold=thr)
        assert is_sparse(Cf.A)


class TestChunkedNewton:
    """Full-batch linear-link Newton through the streamed chunked pass
    (chunked_newton_linear_u_pass + DB/BtB-fed V update)."""

    def _inits(self, rng):
        return (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)),
                np.abs(rng.randn(6, 5)))

    def test_matches_dense_path(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=8, tol=0.0,
                  dtype="float64", random_state=0)
        md = CMF(sparse_mode="dense", **kw).fit(
            Xs, Y, U=U0, V=V0, Z=Z0)
        mc = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(mc.V_, md.V_, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(mc.loss_history_, md.loss_history_,
                                   rtol=1e-10)

    def test_device_loop_matches_host(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, sparse_mode="chunked")
        mh = CMF(loop="host", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        md = CMF(loop="device", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(md.U_, mh.U_, rtol=1e-12)
        np.testing.assert_allclose(md.loss_history_, mh.loss_history_,
                                   rtol=1e-12)

    def test_sigmoid_y_works(self, rng, Xs):
        """Chunked X + sigmoid-linked Y: only X streams; Y is dense."""
        Y = np.abs(rng.randn(90, 6))
        Yb = (Y > np.median(Y)).astype(float)
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, y_link="sigmoid")
        md = CMF(sparse_mode="dense", **kw).fit(Xs, Yb, U=U0, V=V0, Z=Z0)
        mc = CMF(sparse_mode="chunked", **kw).fit(Xs, Yb, U=U0, V=V0,
                                                  Z=Z0)
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-10, atol=1e-12)

    def test_non_negative_projection(self, rng, Xs):
        U0, V0, _ = self._inits(rng)
        m = CMF(n_components=5, solver="newton", max_iter=8, tol=0.0,
                sparse_mode="chunked", random_state=0, dtype="float64")
        m.fit(Xs, None, U=U0, V=V0)
        assert (m.U_ >= 0).all() and (m.V_ >= 0).all()

    def test_sampled_chunked_matches_dense_sampled(self, rng, Xs):
        """sg_sample_ratio < 1 streams via masked sampling
        (solvers/newton.sample_mask): the chunked fit must reproduce the
        dense sampled fit exactly — same draw, gathered sums == masked
        sums."""
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, sg_sample_ratio=0.5)
        md = CMF(sparse_mode="dense", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        mc = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0,
                                                  Z=Z0)
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(mc.V_, md.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(mc.loss_history_, md.loss_history_,
                                   rtol=1e-9)

    def test_sampled_csr_matches_dense_sampled(self, rng, Xs):
        """CSR terms run stochastic Newton through the same masked draw
        (masked spmm numerators + masked row norms)."""
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, sg_sample_ratio=0.5)
        md = CMF(sparse_mode="dense", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(sparse_mode="csr", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(ms.U_, md.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.loss_history_, md.loss_history_,
                                   rtol=1e-9)

    def test_negative_data_allowed(self, rng):
        """Newton accepts negative X — the chunked layout must too."""
        Xn = sp.csr_matrix(rng.randn(137, 90)
                           * (rng.rand(137, 90) > 0.85))
        U0, V0, _ = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0, U_non_negative=False,
                  V_non_negative=False, Z_non_negative=False)
        md = CMF(sparse_mode="dense", **kw).fit(Xn, None, U=U0 - 0.5,
                                                V=V0 - 0.5)
        mc = CMF(sparse_mode="chunked", **kw).fit(Xn, None, U=U0 - 0.5,
                                                  V=V0 - 0.5)
        np.testing.assert_allclose(mc.U_, md.U_, rtol=1e-9, atol=1e-11)


class TestShardedChunked:
    """Per-shard chunked streaming in the rows layout: each shard scans
    its own COO chunks; the shared-V psums are unchanged, so the fit must
    match BOTH the single-device chunked fit and the sharded CSR fit."""

    def _inits(self, rng):
        return (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)),
                np.abs(rng.randn(6, 5)))

    @pytest.fixture(autouse=True)
    def _need_devices(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")

    def test_mu_matches_single_and_csr(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="mu", max_iter=20, tol=0.0,
                  dtype="float64", random_state=0)
        m1 = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(sparse_mode="chunked", n_shards=8, **kw).fit(
            Xs, Y, U=U0, V=V0, Z=Z0)
        mcsr = CMF(sparse_mode="csr", n_shards=8, **kw).fit(
            Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(ms.U_, m1.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.V_, m1.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.loss_history_, m1.loss_history_,
                                   rtol=1e-10)
        np.testing.assert_allclose(ms.U_, mcsr.U_, rtol=1e-9, atol=1e-11)

    def test_newton_matches_single(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0)
        m1 = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(sparse_mode="chunked", n_shards=8, **kw).fit(
            Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(ms.U_, m1.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.V_, m1.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.loss_history_, m1.loss_history_,
                                   rtol=1e-10)

    def test_mu_device_loop_matches_host(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="mu", max_iter=10, tol=0.0,
                  dtype="float64", random_state=0, sparse_mode="chunked",
                  n_shards=8)
        mh = CMF(loop="host", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        md = CMF(loop="device", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(md.U_, mh.U_, rtol=1e-12)
        np.testing.assert_allclose(md.loss_history_, mh.loss_history_,
                                   rtol=1e-12)

    def test_sharded_transform_chunked(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        m = CMF(n_components=5, solver="mu", max_iter=10, tol=0.0,
                dtype="float64", random_state=0,
                sparse_mode="chunked").fit(Xs, Y, U=U0, V=V0, Z=Z0)
        Xn = sp.csr_matrix(np.abs(rng.randn(23, 90))
                           * (rng.rand(23, 90) > 0.7))
        t1 = m.transform(Xn)
        m.n_shards = 8
        t2 = m.transform(Xn)
        np.testing.assert_allclose(t2, t1, rtol=1e-9, atol=1e-11)

    def test_auto_prefers_chunked_over_segsum(self, rng, Xs):
        """'auto' with a beyond-threshold local shard and no BlockEll
        resolves to the stacked chunked layout."""
        import jax.numpy as jnp

        from pycmf_tpu.ops.chunked import is_chunked
        from pycmf_tpu.parallel.sharded import _prepare_rows

        U0 = np.abs(rng.randn(137, 5))
        ops, _, _ = _prepare_rows(Xs, None, U0, 4, jnp.float64,
                                  chunked="auto")
        assert is_chunked(ops.X)
        ops2, _, _ = _prepare_rows(Xs, None, U0, 4, jnp.float64,
                                   chunked="never")
        assert not is_chunked(ops2.X)


class TestShardedChunkedCols:
    """Per-shard chunked streaming in the COLS layout: each shard
    row-chunks its (n, m_loc) column slice; MU's U numerator and the
    Newton U term partials psum exactly as the CSR path's do, and V's
    update streams chunked_spmm_t locally. Fits must match the
    single-device chunked fit."""

    def _inits(self, rng):
        return (np.abs(rng.randn(137, 5)), np.abs(rng.randn(90, 5)),
                np.abs(rng.randn(6, 5)))

    @pytest.fixture(autouse=True)
    def _need_devices(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")

    def test_mu_matches_single_and_csr(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="mu", max_iter=20, tol=0.0,
                  dtype="float64", random_state=0)
        m1 = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(sparse_mode="chunked", n_shards=8, shard_layout="cols",
                 **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        mcsr = CMF(sparse_mode="csr", n_shards=8, shard_layout="cols",
                   **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(ms.U_, m1.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.V_, m1.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.loss_history_, m1.loss_history_,
                                   rtol=1e-10)
        np.testing.assert_allclose(ms.U_, mcsr.U_, rtol=1e-9, atol=1e-11)

    def test_newton_matches_single(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=6, tol=0.0,
                  dtype="float64", random_state=0)
        m1 = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(sparse_mode="chunked", n_shards=8, shard_layout="cols",
                 **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(ms.U_, m1.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.V_, m1.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.loss_history_, m1.loss_history_,
                                   rtol=1e-10)

    def test_mu_device_loop_matches_host(self, rng, Xs):
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="mu", max_iter=10, tol=0.0,
                  dtype="float64", random_state=0, sparse_mode="chunked",
                  n_shards=8, shard_layout="cols")
        mh = CMF(loop="host", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        md = CMF(loop="device", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(md.U_, mh.U_, rtol=1e-12)
        np.testing.assert_allclose(md.loss_history_, mh.loss_history_,
                                   rtol=1e-12)

    def test_newton_nonneg_alpha_matches_single(self, rng, Xs):
        """Projection + elastic net through the cols chunked Newton
        terms (U distributed, V local DB/BtB-fed)."""
        Y = np.abs(rng.randn(90, 6))
        U0, V0, Z0 = self._inits(rng)
        kw = dict(n_components=5, solver="newton", max_iter=5, tol=0.0,
                  dtype="float64", random_state=0, alpha=0.05,
                  l1_ratio=0.3, U_non_negative=True, V_non_negative=True,
                  Z_non_negative=True)
        m1 = CMF(sparse_mode="chunked", **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        ms = CMF(sparse_mode="chunked", n_shards=8, shard_layout="cols",
                 **kw).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(ms.U_, m1.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(ms.V_, m1.V_, rtol=1e-9, atol=1e-11)

    def test_auto_prefers_chunked_over_segsum(self, rng, Xs):
        """cols 'auto' with a beyond-threshold local shard and no
        BlockEll resolves to the stacked chunked layout."""
        import jax.numpy as jnp

        from pycmf_tpu.ops.chunked import is_chunked
        from pycmf_tpu.parallel.sharded import _prepare_cols

        V0 = np.abs(rng.randn(90, 5))
        ops, _, _ = _prepare_cols(Xs, None, V0, 4, jnp.float64,
                                  chunked="auto")
        assert is_chunked(ops.X)
        ops2, _, _ = _prepare_cols(Xs, None, V0, 4, jnp.float64,
                                   chunked="never")
        assert not is_chunked(ops2.X)


class TestChunkedSigmoidNewton:
    """Streamed sigmoid-link Newton (solvers/newton_chunked.py): the
    bigger-than-HBM binary-X path. Oracle = sparse_mode='dense' (same
    math per row, chunk granularity)."""

    def _problem(self, rng):
        Xs = sp.csr_matrix((rng.rand(67, 53) < 0.25).astype(float))
        Y = np.abs(rng.randn(53, 9))
        U0 = rng.randn(67, 4)
        V0 = rng.randn(53, 4)
        Z0 = rng.randn(9, 4)
        return Xs, Y, U0, V0, Z0

    def _base(self, **kw):
        base = dict(n_components=4, solver="newton", x_link="sigmoid",
                    max_iter=4, tol=0.0, dtype="float64", random_state=0,
                    U_non_negative=False, V_non_negative=False,
                    Z_non_negative=False)
        base.update(kw)
        return base

    # 'full' runs 2 iters: its near-indefinite solves amplify fp-
    # association noise ~1000×/iter (measured: bit-identical at iter 1,
    # 1e-8 by iter 4 — same loss to 1e-10 rel), so trajectory-exact
    # comparison is only meaningful over few steps.
    @pytest.mark.parametrize("hf,iters", [("gauss", 4), ("full", 2)])
    def test_matches_dense_path(self, rng, hf, iters):
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base(hessian_form=hf, max_iter=iters)
        d = CMF(sparse_mode="dense", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        c = CMF(sparse_mode="chunked", **base).fit(Xs, Y, U=U0, V=V0,
                                                   Z=Z0)
        np.testing.assert_allclose(c.U_, d.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(c.V_, d.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(c.loss_history_, d.loss_history_,
                                   rtol=1e-9)

    def test_nonneg_and_sigmoid_y(self, rng):
        Xs, _, U0, V0, Z0 = self._problem(rng)
        Yb = (rng.rand(53, 9) < 0.4).astype(float)
        base = self._base(y_link="sigmoid", U_non_negative=True,
                          V_non_negative=True)
        d = CMF(sparse_mode="dense", **base).fit(
            Xs, Yb, U=np.abs(U0), V=np.abs(V0), Z=Z0)
        c = CMF(sparse_mode="chunked", **base).fit(
            Xs, Yb, U=np.abs(U0), V=np.abs(V0), Z=Z0)
        np.testing.assert_allclose(c.U_, d.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(c.V_, d.V_, rtol=1e-9, atol=1e-11)
        assert np.all(c.U_ >= 0) and np.all(c.V_ >= 0)

    def test_transform_fold_in(self, rng):
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base()
        d = CMF(sparse_mode="dense", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        c = CMF(sparse_mode="chunked", **base).fit(Xs, Y, U=U0, V=V0,
                                                   Z=Z0)
        Xn = sp.csr_matrix((np.random.RandomState(9).rand(21, 53)
                            < 0.25).astype(float))
        np.testing.assert_allclose(c.transform(Xn), d.transform(Xn),
                                   rtol=1e-9, atol=1e-11)

    def test_device_loop_matches_host(self, rng):
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base(sparse_mode="chunked")
        h = CMF(loop="host", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        v = CMF(loop="device", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(v.U_, h.U_, rtol=1e-12)
        np.testing.assert_allclose(v.loss_history_, h.loss_history_,
                                   rtol=1e-12)

    def test_auto_streams_over_threshold(self, rng):
        """sparse_mode='auto' + sigmoid keeps 'auto' at the policy layer
        (previously force-'dense'), so past the densify threshold
        as_coupled resolves it to the streamed layout instead of an
        OOM-bound dense copy."""
        from pycmf_tpu.utils.validation import as_coupled

        Xs, _, _, _, _ = self._problem(rng)
        m = CMF(**self._base(sparse_mode="auto"))
        assert m._matrix_sparse_mode(Xs, "sigmoid") == "auto"
        assert m._chunked_ok()
        Xc = as_coupled(Xs, jnp.float64, sparse_mode="auto",
                        chunked_ok=True, densify_threshold=64)
        assert is_chunked(Xc.A)

    def test_sampled_matches_dense_sampled(self, rng):
        """Streamed sigmoid Newton under sg_sample_ratio < 1: the
        per-chunk masked draw (solvers/newton.sample_mask) reproduces
        the dense path's gathered subsample exactly."""
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base(sg_sample_ratio=0.5)
        d = CMF(sparse_mode="dense", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        c = CMF(sparse_mode="chunked", **base).fit(Xs, Y, U=U0, V=V0,
                                                   Z=Z0)
        np.testing.assert_allclose(c.U_, d.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(c.V_, d.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(c.loss_history_, d.loss_history_,
                                   rtol=1e-9)

    def test_sharded_cols_matches_dense(self, rng):
        """Chunked sigmoid in the COLS layout: U's rowwise (G, H, φ)
        stream per chunk and psum over the column shards; V's colwise
        terms are shard-local."""
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base()
        d = CMF(sparse_mode="dense", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(sparse_mode="chunked", n_shards=8,
                shard_layout="cols", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(s.U_, d.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.V_, d.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.loss_history_, d.loss_history_,
                                   rtol=1e-9)

    def test_sharded_grid_matches_dense(self, rng):
        """Chunked sigmoid on the 2-D GRID: U psums over COL, V's
        ChunkedT terms psum over ROW, the streamed masked loss psums
        over both — all with the cell padding masks."""
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        Xs, _, U0, V0, Z0 = self._problem(rng)
        Yb = (rng.rand(53, 9) < 0.4).astype(float)
        base = self._base(y_link="sigmoid")
        d = CMF(sparse_mode="dense", **base).fit(Xs, Yb, U=U0, V=V0,
                                                 Z=Z0)
        s = CMF(sparse_mode="chunked", n_shards=(2, 4),
                shard_layout="grid", **base).fit(Xs, Yb, U=U0, V=V0,
                                                 Z=Z0)
        np.testing.assert_allclose(s.U_, d.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.V_, d.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.loss_history_, d.loss_history_,
                                   rtol=1e-9)

    def test_sharded_cols_device_loop_matches_host(self, rng):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base(sparse_mode="chunked", n_shards=8,
                          shard_layout="cols")
        h = CMF(loop="host", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        v = CMF(loop="device", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(v.U_, h.U_, rtol=1e-12)
        np.testing.assert_allclose(v.loss_history_, h.loss_history_,
                                   rtol=1e-12)

    def test_trials_zero_matches_dense(self, rng):
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base(line_search_trials=0, max_iter=2)
        d = CMF(sparse_mode="dense", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        c = CMF(sparse_mode="chunked", **base).fit(Xs, Y, U=U0, V=V0,
                                                   Z=Z0)
        np.testing.assert_allclose(c.U_, d.U_, rtol=1e-9, atol=1e-11)


class TestChunkedLinearVOnly:
    """V-only (frozen-U) updates on chunked X previously raised; they now
    take one streamed XᵀU pass (DB/BtB Term — the sharded layout's
    existing contract)."""

    def test_v_only_matches_dense(self, rng):
        import jax

        from pycmf_tpu.ops.links import LINEAR
        from pycmf_tpu.solvers.common import make_hyper
        from pycmf_tpu.solvers.newton import run_newton
        from pycmf_tpu.utils.validation import as_coupled

        Xs = sp.csr_matrix(np.abs(rng.randn(67, 53))
                           * (rng.rand(67, 53) > 0.8))
        U0 = jnp.asarray(rng.randn(67, 4))
        V0 = jnp.asarray(rng.randn(53, 4))
        Z0 = jnp.zeros((0, 4), jnp.float64)
        from pycmf_tpu.solvers.common import SolverConfig

        cfg = SolverConfig(has_Y=False, update_U=False, update_V=True,
                           update_Z=False, x_link=LINEAR, y_link=LINEAR,
                           U_non_negative=False, V_non_negative=False,
                           Z_non_negative=False)
        hyper = make_hyper(0.0, 0.5, 1e-9, 0.2, dtype=jnp.float64)
        rng_j = jax.random.PRNGKey(0)
        outs = {}
        for mode in ("dense", "chunked"):
            Xc = as_coupled(Xs, jnp.float64, sparse_mode=mode,
                            chunked_ok=True)
            V, *_ = [np.asarray(a) for a in run_newton(
                Xc, None, U0, V0, Z0, cfg, hyper, max_iter=3, tol=0.0,
                eval_every=1, rng=rng_j)[1:2]]
            outs[mode] = V
        np.testing.assert_allclose(outs["chunked"], outs["dense"],
                                   rtol=1e-9, atol=1e-11)


class TestShardedChunkedSigmoid:
    """Rows-sharded streamed sigmoid Newton: per-shard row-local U
    updates, psummed (G, H_rows, φ) V partials with the shard padding
    mask folded into the chunk scans."""

    def _problem(self, rng):
        Xs = sp.csr_matrix((rng.rand(67, 53) < 0.25).astype(float))
        Y = np.abs(rng.randn(53, 9))
        return (Xs, Y, rng.randn(67, 4), rng.randn(53, 4),
                rng.randn(9, 4))

    def _base(self, **kw):
        base = dict(n_components=4, solver="newton", x_link="sigmoid",
                    max_iter=4, tol=0.0, dtype="float64", random_state=0,
                    U_non_negative=False, V_non_negative=False,
                    Z_non_negative=False)
        base.update(kw)
        return base

    def test_matches_single_device_dense(self, rng):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base()
        d = CMF(sparse_mode="dense", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(sparse_mode="chunked", n_shards=8, **base).fit(
            Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(s.U_, d.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.V_, d.V_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.loss_history_, d.loss_history_,
                                   rtol=1e-9)

    def test_device_loop_and_transform(self, rng):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base(sparse_mode="chunked", n_shards=8)
        h = CMF(loop="host", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        v = CMF(loop="device", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(v.U_, h.U_, rtol=1e-12)
        d = CMF(**self._base(sparse_mode="dense")).fit(
            Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(h.transform(Xs[:20]),
                                   d.transform(Xs[:20]),
                                   rtol=1e-9, atol=1e-11)

    def test_grid_matches_dense(self, rng):
        """Grid chunked-sigmoid cells (previously raised): parity vs
        the dense single-device fit."""
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        Xs, Y, U0, V0, Z0 = self._problem(rng)
        base = self._base()
        d = CMF(sparse_mode="dense", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        s = CMF(sparse_mode="chunked", n_shards=(2, 4),
                shard_layout="grid", **base).fit(Xs, Y, U=U0, V=V0, Z=Z0)
        np.testing.assert_allclose(s.U_, d.U_, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.V_, d.V_, rtol=1e-9, atol=1e-11)
