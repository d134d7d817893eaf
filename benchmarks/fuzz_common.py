"""Shared random-case generator for the two fuzzers (fuzz_configs.py,
fuzz_invariants.py) — one draw function so the config space (layouts,
links, sparse modes, sampling) evolves in ONE place and the scripts
cannot drift apart.

Each case is a tiny CMF problem whose shapes deliberately sit below/
around one tile and do not divide the 8-device mesh, drawn across the
full config space: solver, links, non-negativity, elastic net,
sparsity (incl. the streamed chunked layout for sparse MU draws and for
every sparse sigmoid-X draw), sg_sample_ratio, and all four layouts.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def draw_case(rng: np.random.RandomState) -> dict:
    """Return one random problem + estimator config.

    Keys: X, Y, U0, V0, Z0 (problem; Y/Z0 may be None), kw (CMF kwargs
    minus script-specific ones like max_iter/loop), lay
    (layout name, 'none' = single-chip), skw (the n_shards/shard_layout
    kwargs for lay), sr / sparse (for the scripts' skip logic), desc
    (one-line description).
    """
    n = int(rng.choice([3, 5, 8, 9, 17, 33, 65]))
    m = int(rng.choice([3, 5, 8, 9, 17, 33, 65]))
    q = int(rng.choice([1, 2, 5, 9]))
    k = int(rng.choice([1, 2, 4]))
    solver = str(rng.choice(["mu", "newton"]))
    has_y = rng.rand() < 0.8
    sparse = rng.rand() < 0.3
    smode = "auto"
    alpha = float(rng.choice([0.0, 0.05]))
    lay = str(rng.choice(["none", "rows", "cols", "grid"]))
    nonneg, xl, yl, sr = True, "linear", "linear", 1.0
    if solver == "newton":
        xl = str(rng.choice(["linear", "sigmoid"]))
        yl = str(rng.choice(["linear", "sigmoid"]))
        nonneg = bool(rng.rand() < 0.5)
        if xl == "sigmoid":
            # sparse sigmoid X rides the streamed chunked layout
            # (dense-mode parity is covered by the link tests)
            if sparse:
                smode = "chunked"
        elif rng.rand() < 0.3:
            sr = 0.5
            if sparse:
                # exercise the masked-sampling storage paths (tiny
                # 'auto' problems densify, which would test the dense
                # path only); sharded chunked streaming is full-batch-
                # only, so sharded draws pin CSR
                smode = "csr" if lay != "none" else str(
                    rng.choice(["csr", "chunked"]))
    Xd = np.abs(rng.randn(n, m))
    if xl == "sigmoid":
        Xd = (Xd > np.median(Xd)).astype(float)
    if sparse:
        X = sp.csr_matrix(Xd * (rng.rand(n, m) > 0.5))
        if solver == "mu" and rng.rand() < 0.4:
            smode = "chunked"
    else:
        X = Xd
    Y = None
    if has_y:
        Y = np.abs(rng.randn(m, q))
        if yl == "sigmoid":
            Y = (Y > np.median(Y)).astype(float)
    U0 = np.abs(rng.randn(n, k))
    V0 = np.abs(rng.randn(m, k))
    Z0 = np.abs(rng.randn(q, k)) if has_y else None
    kw = dict(n_components=k, solver=solver, tol=0.0, dtype="float64",
              alpha=alpha, l1_ratio=0.5, sparse_mode=smode,
              x_link=xl, y_link=yl, sg_sample_ratio=sr,
              U_non_negative=nonneg, V_non_negative=nonneg,
              Z_non_negative=nonneg)
    skw = {}
    if lay != "none":
        skw = dict(n_shards=(2, 4) if lay == "grid" else 8,
                   shard_layout=lay)
    desc = (f"n={n} m={m} q={q} k={k} {solver} x={xl} y={yl} "
            f"nn={nonneg} sp={sparse} sm={smode} a={alpha} sr={sr} "
            f"lay={lay}")
    return dict(X=X, Y=Y, U0=U0, V0=V0, Z0=Z0, kw=kw, lay=lay, skw=skw,
                sr=sr, sparse=sparse, desc=desc)
