"""Sigmoid-linked binary matrix factorization with the Newton solver
(BASELINE.json config #2), plus stochastic column subsampling (config #4).

Run: python examples/binary_labels_newton.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

import numpy as np

from pycmf_tpu import CMF
from pycmf_tpu.utils.cache import enable_persistent_cache

# the persistent compile cache turns re-runs' compiles into disk hits
enable_persistent_cache()


def main():
    rng = np.random.RandomState(0)
    n, m, r, k = 4000, 1200, 30, 16

    # ground-truth low-rank structure; Y is binary through a sigmoid
    Ut = rng.randn(n, k) * 0.6
    Vt = rng.randn(m, k) * 0.6
    Zt = rng.randn(r, k) * 0.6
    X = Ut @ Vt.T + 0.05 * rng.randn(n, m)
    Y = (1 / (1 + np.exp(-(Vt @ Zt.T))) > 0.5).astype(np.float32)

    model = CMF(
        n_components=k,
        solver="newton",
        x_link="linear",
        y_link="sigmoid",
        U_non_negative=False,
        V_non_negative=False,
        Z_non_negative=False,
        hessian_pertubation=0.2,
        line_search_trials=8,
        tol=1e-6,
        max_iter=50,
        random_state=0,
        verbose=1,
    )
    t0 = time.time()
    U, V, Z = model.fit_transform(X, Y)
    print(f"fit: {model.n_iter_} Newton iterations in {time.time()-t0:.2f}s")

    P = 1 / (1 + np.exp(-(V @ Z.T)))
    acc = ((P > 0.5) == (Y > 0.5)).mean()
    print(f"binary reconstruction accuracy: {acc:.3%}")

    # stochastic minibatch Newton on a tall X: subsample 30% of the columns
    # entering each row's gradient/Hessian (fixed sample size, static shapes)
    tall = CMF(n_components=k, solver="newton", sg_sample_ratio=0.3,
               U_non_negative=False, V_non_negative=False,
               Z_non_negative=False, max_iter=30, random_state=0)
    Xtall = np.vstack([X, Ut @ Vt.T + 0.05 * rng.randn(n, m)])
    tall.fit(Xtall, Y)
    print(f"stochastic Newton on X {Xtall.shape}: "
          f"loss {tall.loss_history_[0]:.4g} -> {tall.reconstruction_err_:.4g}")


if __name__ == "__main__":
    main()
