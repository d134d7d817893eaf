"""Supervised topic modeling on 20 Newsgroups — the reference's flagship
use case (SURVEY.md §0).

Factor the term×document matrix X jointly with the document×label matrix Y
so the shared document factor V (and hence the term-topic factor U) is
informed by the labels. Falls back to a corpus-shaped synthetic when the
real 20NG isn't cached and cannot be downloaded (set PYCMF_NO_DOWNLOAD=1
to skip the download attempt).

Run: python examples/supervised_topics_20ng.py
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
from pycmf_tpu.utils.datasets import load_20ng


def main():
    X, Y, source = load_20ng(max_features=30000)
    print(f"data: {source}")
    print(f"X (term×doc): {X.shape}, nnz={X.nnz}; Y (doc×label): {Y.shape}")

    model = CMF(
        n_components=20,
        solver="mu",
        alpha=0.01,
        tol=1e-4,
        max_iter=200,
        random_state=0,
        verbose=1,
    )
    t0 = time.time()
    U, V, Z = model.fit_transform(X, Y)
    print(f"fit: {model.n_iter_} iterations in {time.time() - t0:.2f}s, "
          f"objective {model.reconstruction_err_:.6g}")

    # topics = columns of the term factor U
    vocab = [f"term{i}" for i in range(X.shape[0])]
    model.print_topic_terms(vocabulary=vocab, factor="U", n_top_words=8)

    # label affinity of each topic = rows of Z
    top_label = np.asarray(Z).argmax(axis=0)
    print("strongest label per topic:", top_label.tolist())

    # fold-in: solve for factor rows of new data against the fitted V
    U_new = model.transform(X[:50])
    print("fold-in factor for 50 rows:", U_new.shape)


if __name__ == "__main__":
    main()
