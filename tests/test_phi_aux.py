"""Round-5 item #2 (VERDICT r04): zero-extra-pass eval loss for sigmoid
links via the accepted-candidate φ.

V is the last factor updated each Newton iteration (pinned U → Z → V
order) and its backtracking line search already evaluates the per-row
objective φ at the accepted candidate — φⱼ sums the X term, the Y term
and V's own elastic-net penalty, so Σⱼφ + R(U) + R(Z) IS the eval loss.
The step carries Σφ as its aux and the fit loops' loss/tol checks touch
no data matrix at all (previously a sigmoid-linked X re-streamed X at
every eval point — ~10% extra traffic at eval_every=10 on exactly the
biggest-X paths).

Pinned here:
- the φ-aux value equals total_loss at the post-step iterate (f64,
  rtol 1e-12) for dense and chunked sigmoid X, with and without Y;
- fit histories are identical with the aux ON (default) vs forced OFF;
- the estimator's sigmoid-X Newton fits actually SELECT the φ-aux
  (spy on _aux_kind), and gate it off for sampled fits / trials=0;
- no structural X pass exists in _aux_loss_phi (it reads only factors).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pycmf_tpu import CMF
from pycmf_tpu.ops.losses import total_loss
from pycmf_tpu.solvers.common import SolverConfig, make_hyper
from tests.conftest import make_problem

import pycmf_tpu.solvers.newton as nt


def _sigmoid_problem(rng, n=50, m=30, r=8, k=3):
    X, Y = make_problem(rng, n=n, m=m, r=r, k=k, non_negative=False)
    X = (X > np.median(X)).astype(float)
    return X, Y


def _inits(rng, n, m, r, k):
    return (rng.randn(n, k), rng.randn(m, k), rng.randn(r, k))


class TestPhiAuxValue:
    """Σφ(V_new) + R(U) + R(Z) == total_loss at the post-step iterate."""

    def _check_step(self, X, Y, U, V, Z, cfg, hyper, rng_key):
        step = nt.make_newton_step(cfg, with_aux="phi")
        U2, V2, Z2, phi_sum = step(X, Y, U, V, Z, hyper, rng_key)
        got = nt._aux_loss_phi(cfg)((X, Y, U2, V2, Z2), phi_sum, hyper)
        YA = Y.A if cfg.has_Y else None
        want = total_loss(X.A, YA, U2, V2, Z2, cfg.x_link, cfg.y_link,
                          hyper.alpha, hyper.l1_ratio, x_a_sq=X.a_sq,
                          y_a_sq=(Y.a_sq if cfg.has_Y else None))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
        # and the no-aux step produces the SAME factors (aux is free)
        U3, V3, Z3 = nt.make_newton_step(cfg)(X, Y, U, V, Z, hyper,
                                              rng_key)
        np.testing.assert_allclose(np.asarray(V2), np.asarray(V3),
                                   rtol=1e-14)

    def test_dense_sigmoid_x_linear_y(self, rng):
        from pycmf_tpu.utils.validation import as_coupled

        X, Y = _sigmoid_problem(rng)
        U, V, Z = _inits(rng, 50, 30, 8, 3)
        cfg = SolverConfig(x_link="sigmoid", y_link="linear",
                           U_non_negative=False, V_non_negative=False,
                           Z_non_negative=False)
        Xc = as_coupled(X, jnp.float64)
        Yc = as_coupled(Y, jnp.float64)
        self._check_step(Xc, Yc, jnp.asarray(U), jnp.asarray(V),
                         jnp.asarray(Z), cfg, make_hyper(dtype=jnp.float64),
                         jax.random.PRNGKey(0))

    def test_dense_sigmoid_both_links_with_penalty(self, rng):
        from pycmf_tpu.utils.validation import as_coupled

        X, Y = _sigmoid_problem(rng)
        Yb = (Y > np.median(Y)).astype(float)
        U, V, Z = _inits(rng, 50, 30, 8, 3)
        cfg = SolverConfig(x_link="sigmoid", y_link="sigmoid",
                           U_non_negative=False, V_non_negative=False,
                           Z_non_negative=False)
        hyper = make_hyper(alpha=0.13, l1_ratio=0.4, dtype=jnp.float64)
        Xc = as_coupled(X, jnp.float64)
        Yc = as_coupled(Yb, jnp.float64)
        self._check_step(Xc, Yc, jnp.asarray(U), jnp.asarray(V),
                         jnp.asarray(Z), cfg, hyper, jax.random.PRNGKey(1))

    def test_dense_sigmoid_no_y(self, rng):
        from pycmf_tpu.utils.validation import as_coupled

        X, _ = _sigmoid_problem(rng)
        U, V, _ = _inits(rng, 50, 30, 8, 3)
        cfg = SolverConfig(x_link="sigmoid", has_Y=False, update_Z=False,
                           U_non_negative=False, V_non_negative=False)
        Xc = as_coupled(X, jnp.float64)
        step = nt.make_newton_step(cfg, with_aux="phi")
        hyper = make_hyper(dtype=jnp.float64)
        Yc = as_coupled(np.zeros((30, 1)), jnp.float64)
        U2, V2, _, phi_sum = step(Xc, Yc, jnp.asarray(U), jnp.asarray(V),
                                  jnp.zeros((1, 3), jnp.float64), hyper,
                                  jax.random.PRNGKey(2))
        got = nt._aux_loss_phi(cfg)((Xc, Yc, U2, V2, None), phi_sum, hyper)
        want = total_loss(Xc.A, None, U2, V2, None, "sigmoid", "linear",
                          hyper.alpha, hyper.l1_ratio, x_a_sq=Xc.a_sq)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)

    def test_nonneg_projection_and_kept_rows(self, rng):
        """Rows that reject every candidate keep M — their φ must be
        φ(M_kept), not a candidate's. Force rejections with a huge
        damping (direction ≈ 0 still strictly decreases rarely) plus
        non-negativity so projection is active."""
        from pycmf_tpu.utils.validation import as_coupled

        X, Y = _sigmoid_problem(rng)
        U, V, Z = (np.abs(a) for a in _inits(rng, 50, 30, 8, 3))
        cfg = SolverConfig(x_link="sigmoid", y_link="linear",
                           line_search_trials=2)
        hyper = make_hyper(alpha=0.05, l1_ratio=0.2,
                           hessian_pertubation=50.0, dtype=jnp.float64)
        Xc = as_coupled(X, jnp.float64)
        Yc = as_coupled(Y, jnp.float64)
        self._check_step(Xc, Yc, jnp.asarray(U), jnp.asarray(V),
                         jnp.asarray(Z), cfg, hyper, jax.random.PRNGKey(3))


class TestPhiAuxFitParity:
    """Whole-fit histories: φ-aux ON (default) == forced OFF, f64."""

    def _pair(self, X, Y, inits, monkeypatch, **kw):
        U0, V0, Z0 = inits
        out = []
        for force_off in (False, True):
            if force_off:
                monkeypatch.setattr(nt, "_aux_kind",
                                    lambda cfg, X, U0: None)
            else:
                monkeypatch.undo()
            m = CMF(n_components=3, solver="newton", x_link="sigmoid",
                    dtype="float64", tol=0.0, random_state=0,
                    U_non_negative=False, V_non_negative=False,
                    Z_non_negative=False, **kw)
            m.fit(X, Y, U=U0, V=V0, Z=Z0)
            out.append(m)
        return out

    def test_host_loop_dense(self, rng, monkeypatch):
        X, Y = _sigmoid_problem(rng, n=53, m=31)
        inits = _inits(rng, 53, 31, 8, 3)
        m1, m2 = self._pair(X, Y, inits, monkeypatch, max_iter=8,
                            eval_every=2, loop="host")
        np.testing.assert_allclose(m1.loss_history_, m2.loss_history_,
                                   rtol=1e-12)
        np.testing.assert_allclose(m1.V_, m2.V_, rtol=1e-14)

    def test_device_loop_dense(self, rng, monkeypatch):
        X, Y = _sigmoid_problem(rng, n=54, m=32)
        inits = _inits(rng, 54, 32, 8, 3)
        m1, m2 = self._pair(X, Y, inits, monkeypatch, max_iter=8,
                            eval_every=3, loop="device")
        np.testing.assert_allclose(m1.loss_history_, m2.loss_history_,
                                   rtol=1e-12)

    def test_chunked_sigmoid_x(self, rng, monkeypatch):
        import scipy.sparse as sp

        X, Y = _sigmoid_problem(rng, n=55, m=33)
        Xs = sp.csr_matrix(X)
        inits = _inits(rng, 55, 33, 8, 3)
        m1, m2 = self._pair(Xs, Y, inits, monkeypatch, max_iter=6,
                            eval_every=2, sparse_mode="chunked",
                            loop="host")
        np.testing.assert_allclose(m1.loss_history_, m2.loss_history_,
                                   rtol=1e-12)
        np.testing.assert_allclose(m1.V_, m2.V_, rtol=1e-14)

    def test_early_stop_matches(self, rng, monkeypatch):
        """The stop rule reads the aux loss — same stopping point."""
        X, Y = _sigmoid_problem(rng, n=56, m=34)
        inits = _inits(rng, 56, 34, 8, 3)
        U0, V0, Z0 = inits
        out = []
        for force_off in (False, True):
            if force_off:
                monkeypatch.setattr(nt, "_aux_kind",
                                    lambda cfg, X, U0: None)
            m = CMF(n_components=3, solver="newton", x_link="sigmoid",
                    dtype="float64", tol=1e-3, max_iter=100, eval_every=2,
                    random_state=0, U_non_negative=False,
                    V_non_negative=False, Z_non_negative=False)
            m.fit(X, Y, U=U0, V=V0, Z=Z0)
            out.append(m)
        assert out[0].n_iter_ == out[1].n_iter_
        assert out[0].n_iter_ < 100


class TestPhiAuxGating:
    def _kind_spy(self, monkeypatch):
        picked = []
        orig = nt._aux_kind

        def spy(cfg, X, U0):
            k = orig(cfg, X, U0)
            picked.append(k)
            return k

        monkeypatch.setattr(nt, "_aux_kind", spy)
        return picked

    def test_sigmoid_x_selects_phi(self, rng, monkeypatch):
        picked = self._kind_spy(monkeypatch)
        X, Y = _sigmoid_problem(rng, n=41, m=23)
        CMF(n_components=3, solver="newton", x_link="sigmoid", max_iter=3,
            dtype="float64", random_state=0, U_non_negative=False,
            V_non_negative=False, Z_non_negative=False).fit(X, Y)
        assert picked == ["phi"]

    def test_sampled_fit_gates_off(self, rng, monkeypatch):
        picked = self._kind_spy(monkeypatch)
        X, Y = _sigmoid_problem(rng, n=42, m=24)
        CMF(n_components=3, solver="newton", x_link="sigmoid", max_iter=3,
            sg_sample_ratio=0.5, dtype="float64", random_state=0,
            U_non_negative=False, V_non_negative=False,
            Z_non_negative=False).fit(X, Y)
        assert picked == [None]

    def test_frozen_v_gates_off(self, rng, monkeypatch):
        """transform() freezes V — the φ-aux needs the V update."""
        X, Y = _sigmoid_problem(rng, n=43, m=25)
        m = CMF(n_components=3, solver="newton", x_link="sigmoid",
                max_iter=3, dtype="float64", random_state=0,
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False).fit(X, Y)
        picked = self._kind_spy(monkeypatch)
        m.transform(X)
        assert all(k != "phi" for k in picked)

    def test_structurally_no_data_pass(self):
        """_aux_loss_phi never touches X/Y data: evaluating it with
        data leaves replaced by poison objects must still work."""
        cfg = SolverConfig(x_link="sigmoid", y_link="sigmoid")

        class Poison:
            def __getattr__(self, name):
                raise AssertionError(
                    f"aux loss touched the data matrix ({name})")

        class FakeCoupled:
            A = Poison()
            a_sq = None

        U = jnp.ones((4, 2))
        V = jnp.ones((5, 2))
        Z = jnp.ones((3, 2))
        hyper = make_hyper(alpha=0.1, l1_ratio=0.5)
        got = nt._aux_loss_phi(cfg)(
            (FakeCoupled(), FakeCoupled(), U, V, Z),
            jnp.asarray(7.0), hyper)
        # 7 + pen(U) + pen(Z); pen(M)=alpha*(l1r*sum|M| + .5*(1-l1r)*sumM²)
        pen = 0.1 * (0.5 * 8 + 0.5 * 0.5 * 8)
        penz = 0.1 * (0.5 * 6 + 0.5 * 0.5 * 6)
        np.testing.assert_allclose(float(got), 7.0 + pen + penz, rtol=1e-6)


def _manual_loss(X, Y, m, x_link, y_link, alpha=0.0, l1_ratio=0.0):
    """Independent f64 numpy loss of the returned factors."""
    def link(A, f):
        return 1.0 / (1.0 + np.exp(-A)) if f == "sigmoid" else A

    def pen(M):
        return alpha * (l1_ratio * np.abs(M).sum()
                        + 0.5 * (1 - l1_ratio) * (M ** 2).sum())

    rx = X - link(m.U_ @ m.V_.T, x_link)
    ry = Y - link(m.V_ @ m.Z_.T, y_link)
    return (0.5 * (rx ** 2).sum() + 0.5 * (ry ** 2).sum()
            + pen(m.U_) + pen(m.V_) + pen(m.Z_))


class TestPhiAuxSharded:
    """Sharded φ-aux (rows/cols): the REPORTED eval loss must equal the
    independent numpy loss of the returned factors — an absolute check,
    so a consistently-wrong aux on both sides of a parity pair cannot
    hide. Both fit loops are exercised; n=67 is not divisible by 8, so
    the padding rows' masks are too."""

    @pytest.mark.parametrize("layout", ["rows", "cols"])
    @pytest.mark.parametrize("loop", ["host", "device"])
    def test_reported_loss_is_exact(self, rng, layout, loop):
        X, Y = _sigmoid_problem(rng, n=67, m=53, r=9)
        U0, V0, Z0 = _inits(rng, 67, 53, 9, 4)
        m = CMF(n_components=4, solver="newton", x_link="sigmoid",
                max_iter=6, eval_every=3, tol=0.0, dtype="float64",
                alpha=0.07, l1_ratio=0.3, n_shards=8, shard_layout=layout,
                loop=loop, U_non_negative=False,
                V_non_negative=False, Z_non_negative=False)
        m.fit(X, Y, U=U0, V=V0, Z=Z0)
        want = _manual_loss(X, Y, m, "sigmoid", "linear",
                            alpha=0.07, l1_ratio=0.3)
        np.testing.assert_allclose(m.loss_history_[-1], want, rtol=1e-10)

    @pytest.mark.parametrize("loop", ["host", "device"])
    def test_rows_no_extra_x_pass(self, rng, loop, monkeypatch):
        """Spy: after L0, `_loss_rows` (the only rows-layout code path
        that re-streams X) never runs for a sigmoid-X Newton fit."""
        import pycmf_tpu.parallel.sharded as sh

        calls = []
        orig = sh._loss_rows

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(sh, "_loss_rows", spy)
        X, Y = _sigmoid_problem(rng, n=66, m=52, r=9)
        m = CMF(n_components=4, solver="newton", x_link="sigmoid",
                max_iter=9, eval_every=3, tol=0.0, dtype="float64",
                random_state=0, n_shards=8, loop=loop,
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False)
        m.fit(X, Y)
        # host loop: one L0 trace; device loop: loss_core traced once
        # inside the single dispatch (L0), evals go through the aux
        assert len(calls) == 1
        want = _manual_loss(X, Y, m, "sigmoid", "linear")
        np.testing.assert_allclose(m.loss_history_[-1], want, rtol=1e-10)

    def test_chunked_sigmoid_rows_phi_aux(self, rng):
        """Streamed chunked sigmoid X on the rows layout: the biggest-X
        path the φ-aux exists for — reported loss must stay exact."""
        import scipy.sparse as sp

        X, Y = _sigmoid_problem(rng, n=66, m=52, r=9)
        Xs = sp.csr_matrix(X)
        U0, V0, Z0 = _inits(rng, 66, 52, 9, 4)
        m = CMF(n_components=4, solver="newton", x_link="sigmoid",
                max_iter=6, eval_every=2, tol=0.0, dtype="float64",
                sparse_mode="chunked", n_shards=8,
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False)
        m.fit(Xs, Y, U=U0, V=V0, Z=Z0)
        want = _manual_loss(X, Y, m, "sigmoid", "linear")
        np.testing.assert_allclose(m.loss_history_[-1], want, rtol=1e-10)


class TestPhiAuxGrid:
    """Grid-layout φ-aux: X-side φ psummed over ROW inside the line
    search, masked row sums psummed over COL; 67×53 on a 2×4 grid pads
    both axes."""

    @pytest.mark.parametrize("loop", ["host", "device"])
    def test_reported_loss_is_exact(self, rng, loop):
        X, Y = _sigmoid_problem(rng, n=67, m=53, r=9)
        U0, V0, Z0 = _inits(rng, 67, 53, 9, 4)
        m = CMF(n_components=4, solver="newton", x_link="sigmoid",
                max_iter=6, eval_every=3, tol=0.0, dtype="float64",
                alpha=0.07, l1_ratio=0.3, n_shards=(2, 4),
                shard_layout="grid", loop=loop,
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False)
        m.fit(X, Y, U=U0, V=V0, Z=Z0)
        want = _manual_loss(X, Y, m, "sigmoid", "linear",
                            alpha=0.07, l1_ratio=0.3)
        np.testing.assert_allclose(m.loss_history_[-1], want, rtol=1e-10)

    def test_no_extra_x_pass(self, rng, monkeypatch):
        import pycmf_tpu.parallel.grid as gr

        calls = []
        orig = gr._loss_grid

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(gr, "_loss_grid", spy)
        X, Y = _sigmoid_problem(rng, n=65, m=51, r=9)
        m = CMF(n_components=4, solver="newton", x_link="sigmoid",
                max_iter=9, eval_every=3, tol=0.0, dtype="float64",
                random_state=0, n_shards=(2, 4), shard_layout="grid",
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False)
        m.fit(X, Y)
        assert len(calls) == 1   # the initial L0 only
        want = _manual_loss(X, Y, m, "sigmoid", "linear")
        np.testing.assert_allclose(m.loss_history_[-1], want, rtol=1e-10)

    def test_chunked_sigmoid_grid_phi_aux(self, rng):
        import scipy.sparse as sp

        X, Y = _sigmoid_problem(rng, n=66, m=52, r=9)
        Xs = sp.csr_matrix(X)
        U0, V0, Z0 = _inits(rng, 66, 52, 9, 4)
        m = CMF(n_components=4, solver="newton", x_link="sigmoid",
                max_iter=4, eval_every=2, tol=0.0, dtype="float64",
                sparse_mode="chunked", n_shards=(2, 4),
                shard_layout="grid", U_non_negative=False,
                V_non_negative=False, Z_non_negative=False)
        m.fit(Xs, Y, U=U0, V=V0, Z=Z0)
        want = _manual_loss(X, Y, m, "sigmoid", "linear")
        np.testing.assert_allclose(m.loss_history_[-1], want, rtol=1e-10)
