"""Faithful NumPy re-implementation of the reference's update rules.

PyCMF itself is not installable in this environment (no network; the
reference mount is empty — SURVEY.md provenance notice), so this module is
the CPU stand-in baseline (bench.py) and the independent oracle for the
golden parity tests: it implements the MU rules and the row-wise Newton
update from SURVEY.md §0 directly in NumPy/SciPy, with the same pinned
conventions as pycmf_tpu (update order U→Z→V, sklearn-style regularized
denominators, Gauss-Newton weights, backtracking line search on strict
decrease, projection after step).

Note: this vectorized NumPy version is *faster* than the reference's
per-row Python/numba loops (SURVEY.md §3.1), so speedups measured against it
are conservative lower bounds on the speedup vs PyCMF.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _sigmoid(t):
    return 1.0 / (1.0 + np.exp(-np.clip(t, -60, 60)))


def _apply_link(link, t):
    return t if link == "linear" else _sigmoid(t)


def _mm(A, B):
    out = A @ B
    return np.asarray(out)


def loss(X, Y, U, V, Z, alpha=0.0, l1_ratio=0.0, x_link="linear",
         y_link="linear"):
    def term(A, M, B, link):
        if sp.issparse(A):
            if link == "linear":
                a_sq = float((A.data ** 2).sum())
                inner = float(np.sum(_mm(A, B) * M))
                cross = float(np.sum((M.T @ M) * (B.T @ B)))
                return 0.5 * (a_sq - 2 * inner + cross)
            A = np.asarray(A.todense())
        R = np.asarray(A) - _apply_link(link, M @ B.T)
        return 0.5 * float(np.sum(R * R))

    def pen(M):
        return alpha * (l1_ratio * np.abs(M).sum()
                        + 0.5 * (1 - l1_ratio) * (M * M).sum())

    out = term(X, U, V, x_link) + pen(U) + pen(V)
    if Y is not None:
        out += term(Y, V, Z, y_link) + pen(Z)
    return out


def mu_step(X, Y, U, V, Z, alpha=0.0, l1_ratio=0.0, eps=1e-10):
    """One MU iteration (SURVEY.md §0 rules), order U → Z → V."""
    l1 = alpha * l1_ratio
    l2 = alpha * (1 - l1_ratio)
    VtV = V.T @ V
    U = U * _mm(X, V) / (U @ VtV + l1 + l2 * U + eps)
    if Y is not None:
        VtV = V.T @ V
        Z = Z * _mm(Y.T, V) / (Z @ VtV + l1 + l2 * Z + eps)
        num = _mm(X.T, U) + _mm(Y, Z)
        S = U.T @ U + Z.T @ Z
    else:
        num = _mm(X.T, U)
        S = U.T @ U
    V = V * num / (V @ S + l1 + l2 * V + eps)
    return U, V, Z


def run_mu(X, Y, U, V, Z, alpha=0.0, l1_ratio=0.0, eps=1e-10,
           max_iter=200, tol=1e-4, eval_every=10):
    loss_init = loss(X, Y, U, V, Z, alpha, l1_ratio)
    prev = loss_init
    history = [loss_init]
    n_iter = 0
    while n_iter < max_iter:
        for _ in range(min(eval_every, max_iter - n_iter)):
            U, V, Z = mu_step(X, Y, U, V, Z, alpha, l1_ratio, eps)
            n_iter += 1
        cur = loss(X, Y, U, V, Z, alpha, l1_ratio)
        history.append(cur)
        if loss_init > 0 and (prev - cur) / loss_init < tol:
            break
        prev = cur
    return U, V, Z, n_iter, history


def fold_in_mu(X, V, U, alpha=0.0, l1_ratio=0.0, eps=1e-10, n_iter=30):
    """Fold-in (``CMF.transform`` with solver='mu'): the MU rule on U alone,
    with V (and Z) held fixed, for a fixed iteration count."""
    l1 = alpha * l1_ratio
    l2 = alpha * (1 - l1_ratio)
    XV = _mm(X, V)
    VtV = V.T @ V
    for _ in range(n_iter):
        U = U * XV / (U @ VtV + l1 + l2 * U + eps)
    return U


def newton_update_factor(M, terms, alpha=0.0, l1_ratio=0.0,
                         hessian_pertubation=0.2, non_negative=True,
                         trials=8, hessian_form="gauss"):
    """Batched-in-numpy equivalent of the row-wise Newton update."""
    p, k = M.shape
    l1 = alpha * l1_ratio
    l2 = alpha * (1 - l1_ratio)
    G = l1 * np.sign(M) + l2 * M
    H_shared = (l2 + hessian_pertubation) * np.eye(k)
    H_rows = None
    ctxs = []
    for D, B, link in terms:
        if link == "linear":
            BtB = B.T @ B
            DB = _mm(D, B)
            G = G + M @ BtB - DB
            H_shared = H_shared + BtB
            if sp.issparse(D):
                row_sq = np.asarray(D.multiply(D).sum(axis=1)).ravel()
            else:
                row_sq = np.sum(np.asarray(D) ** 2, axis=1)
            ctxs.append(("linear", DB, BtB, row_sq))
        else:
            D = np.asarray(D.todense()) if sp.issparse(D) else np.asarray(D)
            P = _sigmoid(M @ B.T)
            R = P - D
            fp = P * (1 - P)
            W = fp * fp
            if hessian_form == "full":
                W = W + R * (fp * (1 - 2 * P))
            G = G + (R * fp) @ B
            Hr = np.einsum("pq,qk,ql->pkl", W, B, B)
            H_rows = Hr if H_rows is None else H_rows + Hr
            ctxs.append(("sigmoid", D, B))

    if H_rows is None:
        d = np.linalg.solve(H_shared, G.T).T
    else:
        d = np.linalg.solve(H_rows + H_shared[None], G[..., None])[..., 0]

    def project(Mc):
        return np.maximum(Mc, 0.0) if non_negative else Mc

    if trials <= 0:
        return project(M - d)

    def phi(Mc):
        out = l1 * np.abs(Mc).sum(axis=1) + 0.5 * l2 * (Mc * Mc).sum(axis=1)
        for ctx in ctxs:
            if ctx[0] == "linear":
                _, DB, BtB, row_sq = ctx
                out = out + 0.5 * (row_sq - 2 * np.sum(DB * Mc, axis=1)
                                   + np.sum((Mc @ BtB) * Mc, axis=1))
            else:
                _, D, B = ctx
                R = D - _sigmoid(Mc @ B.T)
                out = out + 0.5 * np.sum(R * R, axis=1)
        return out

    phi0 = phi(M)
    best = M.copy()
    done = np.zeros(p, dtype=bool)
    for t in range(trials):
        Mc = project(M - (0.5 ** t) * d)
        acc = (phi(Mc) < phi0) & ~done
        best[acc] = Mc[acc]
        done |= acc
    return best


def newton_step(X, Y, U, V, Z, alpha=0.0, l1_ratio=0.0,
                hessian_pertubation=0.2, x_link="linear", y_link="linear",
                non_negative=(True, True, True), trials=8,
                hessian_form="gauss"):
    kw = dict(alpha=alpha, l1_ratio=l1_ratio,
              hessian_pertubation=hessian_pertubation, trials=trials,
              hessian_form=hessian_form)
    U = newton_update_factor(U, [(X, V, x_link)],
                             non_negative=non_negative[0], **kw)
    if Y is not None:
        Yt = Y.T.tocsr() if sp.issparse(Y) else Y.T
        Z = newton_update_factor(Z, [(Yt, V, y_link)],
                                 non_negative=non_negative[2], **kw)
        Xt = X.T.tocsr() if sp.issparse(X) else X.T
        V = newton_update_factor(V, [(Xt, U, x_link), (Y, Z, y_link)],
                                 non_negative=non_negative[1], **kw)
    else:
        Xt = X.T.tocsr() if sp.issparse(X) else X.T
        V = newton_update_factor(V, [(Xt, U, x_link)],
                                 non_negative=non_negative[1], **kw)
    return U, V, Z


def run_newton(X, Y, U, V, Z, max_iter=50, tol=1e-4, eval_every=5, **kw):
    alpha = kw.get("alpha", 0.0)
    l1_ratio = kw.get("l1_ratio", 0.0)
    x_link = kw.get("x_link", "linear")
    y_link = kw.get("y_link", "linear")
    loss_init = loss(X, Y, U, V, Z, alpha, l1_ratio, x_link, y_link)
    prev = loss_init
    history = [loss_init]
    n_iter = 0
    while n_iter < max_iter:
        for _ in range(min(eval_every, max_iter - n_iter)):
            U, V, Z = newton_step(X, Y, U, V, Z, **kw)
            n_iter += 1
        cur = loss(X, Y, U, V, Z, alpha, l1_ratio, x_link, y_link)
        history.append(cur)
        if loss_init > 0 and (prev - cur) / loss_init < tol:
            break
        prev = cur
    return U, V, Z, n_iter, history
