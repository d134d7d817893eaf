"""Full benchmark sweep over the five BASELINE.json configs.

(bench.py at the repo root is the single-metric harness; this is the
developer-facing sweep over all five configurations.)

Run on the GPU:        python benchmarks/run_all.py
Smoke on CPU:          python benchmarks/run_all.py --cpu --small
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from pycmf_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()


def timed_fit(model, X, Y, U0, V0, Z0):
    # warm-up with IDENTICAL static shapes (the device-fit jit is keyed on
    # (max_iter, eval_every) — a different warm max_iter leaks a full
    # recompile into the timed run), then time a fresh fit.
    # NB: each estimator fit re-uploads the data, so these numbers are
    # upper bounds — bench.py times the solver runs with pre-built
    # operands instead.
    import copy

    warm = copy.deepcopy(model)
    warm.fit(X, Y, U=U0, V=V0, Z=Z0)
    t0 = time.perf_counter()
    model.fit(X, Y, U=U0, V=V0, Z=Z0)
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="shrink problems for a smoke run")
    ap.add_argument("--skip-baseline", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from baselines import numpy_cmf
    from pycmf_tpu import CMF
    from pycmf_tpu.utils.datasets import synthetic_20ng
    from pycmf_tpu.utils.init import initialize_factors

    sc = 8 if args.small else 1
    rng = np.random.RandomState(0)
    results = []

    def record(name, t_ours, t_np, extra=""):
        sp = (t_np / t_ours) if (t_ours and t_np) else float("nan")
        results.append(dict(config=name, device_s=round(t_ours, 4),
                            numpy_s=round(t_np, 4) if t_np else None,
                            speedup=round(sp, 2) if t_np else None,
                            extra=extra))
        print(f"[{name}] ours {t_ours:.3f}s"
              + (f", numpy {t_np:.3f}s, speedup {sp:.1f}x" if t_np else "")
              + (f" ({extra})" if extra else ""), file=sys.stderr, flush=True)

    k = 20
    common = dict(tol=1e-4, max_iter=200, eval_every=10, random_state=0)

    # -- config 1: MU, dense synthetic X(2k×1k), Y(1k×200), k=20 ----------
    n, m, r = 2000 // sc, 1000 // sc, 200 // sc
    X = np.abs(rng.randn(n, m))
    Y = np.abs(rng.randn(m, r))
    U0, V0, Z0 = initialize_factors(X, Y, k, random_state=0)
    t = timed_fit(CMF(n_components=k, solver="mu", **common), X, Y, U0, V0, Z0)
    t_np = None
    if not args.skip_baseline:
        t0 = time.perf_counter()
        numpy_cmf.run_mu(X, Y, U0.copy(), V0.copy(), Z0.copy(),
                         max_iter=200, tol=1e-4)
        t_np = time.perf_counter() - t0
    record("1:mu_dense_2kx1k", t, t_np)

    # -- config 2: Newton, sigmoid link on binary Y ------------------------
    Vt = rng.randn(m, k) * 0.5
    Zt = rng.randn(r, k) * 0.5
    Yb = (1 / (1 + np.exp(-(Vt @ Zt.T))) > 0.5).astype(np.float64)
    Xn = rng.randn(n, m)
    U0, V0, Z0 = initialize_factors(Xn, Yb, k, random_state=0,
                                    U_non_negative=False,
                                    V_non_negative=False,
                                    Z_non_negative=False)
    nt = dict(n_components=k, solver="newton", y_link="sigmoid",
              U_non_negative=False, V_non_negative=False,
              Z_non_negative=False, tol=1e-5, max_iter=50, eval_every=5,
              random_state=0)
    t = timed_fit(CMF(**nt), Xn, Yb, U0, V0, Z0)
    t_np = None
    if not args.skip_baseline:
        t0 = time.perf_counter()
        numpy_cmf.run_newton(Xn, Yb, U0.copy(), V0.copy(), Z0.copy(),
                             max_iter=50, tol=1e-5, eval_every=5,
                             y_link="sigmoid", non_negative=(False,) * 3)
        t_np = time.perf_counter() - t0
    record("2:newton_sigmoid_binaryY", t, t_np)

    # -- config 3: sparse CSR 20NG + one-hot labels ------------------------
    if args.small:
        Xs, Ys = synthetic_20ng(n_docs=400, n_terms=1500, random_state=0)
        src = "small synthetic"
    else:
        Xs, Ys = synthetic_20ng(random_state=0)
        src = "synthetic 20NG-shaped"
    U0, V0, Z0 = initialize_factors(Xs, Ys, k, random_state=0)
    # The estimator fit re-uploads the (auto-densified) matrix every call.
    # Report BOTH: the estimator fit and the solver run with
    # device-resident operands (what bench.py times).
    import jax.numpy as jnp

    from pycmf_tpu.solvers.common import SolverConfig, make_hyper
    from pycmf_tpu.solvers.mu import run_mu
    from pycmf_tpu.utils.validation import as_coupled

    t = timed_fit(CMF(n_components=k, solver="mu", **common),
                  Xs, Ys, U0, V0, Z0)
    Xc = as_coupled(Xs, jnp.float32)
    Yc = as_coupled(Ys, jnp.float32)
    cfg3 = SolverConfig()
    hyp3 = make_hyper(dtype=jnp.float32)
    kw3 = dict(max_iter=200, tol=1e-4, eval_every=10,
               loop=CMF(loop="auto")._resolve_loop())
    run_mu(Xc, Yc, jnp.asarray(U0, jnp.float32),
           jnp.asarray(V0, jnp.float32), jnp.asarray(Z0, jnp.float32),
           cfg3, hyp3, **kw3)  # warm
    t0 = time.perf_counter()
    run_mu(Xc, Yc, jnp.asarray(U0, jnp.float32),
           jnp.asarray(V0, jnp.float32), jnp.asarray(Z0, jnp.float32),
           cfg3, hyp3, **kw3)
    t_resident = time.perf_counter() - t0
    t_np = None
    if not args.skip_baseline:
        t0 = time.perf_counter()
        numpy_cmf.run_mu(Xs.astype(np.float64), Ys.astype(np.float64),
                         U0.copy(), V0.copy(), Z0.copy(), max_iter=200,
                         tol=1e-4)
        t_np = time.perf_counter() - t0
    record("3:mu_sparse_20ng", t, t_np,
           extra=f"{src}; fit() includes the upload — "
                 f"solver with resident data: {t_resident:.3f}s "
                 f"({(t_np or 0) / t_resident:.1f}x)")

    # -- config 4: stochastic minibatch Newton on tall X -------------------
    tall_n = 20000 // sc
    Xt = np.abs(rng.randn(tall_n, m))
    Yt_ = np.abs(rng.randn(m, r))
    U0, V0, Z0 = initialize_factors(Xt, Yt_, k, random_state=0)
    st = dict(n_components=k, solver="newton", sg_sample_ratio=0.25,
              tol=1e-5, max_iter=30, eval_every=5, random_state=0)
    t = timed_fit(CMF(**st), Xt, Yt_, U0, V0, Z0)
    record("4:newton_stochastic_tallX", t, None,
           extra=f"n={tall_n}, sample_ratio=0.25")

    # -- config 5: sharded CMF over the mesh -------------------------------
    n_dev = len(jax.devices())
    if n_dev > 1:
        Xb = np.abs(rng.randn(8 * 2048 // sc, m))
        U0, V0, Z0 = initialize_factors(Xb, Y, k, random_state=0)
        t = timed_fit(CMF(n_components=k, solver="mu", n_shards=n_dev,
                          **common), Xb, Y, U0, V0, Z0)
        record("5:mu_sharded_rows", t, None, extra=f"{n_dev} devices")
    else:
        print("[5:mu_sharded_rows] skipped (1 device)", file=sys.stderr)

    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
