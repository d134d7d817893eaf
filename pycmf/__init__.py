"""Drop-in compatibility alias for the upstream ``pycmf`` package name.

Users of the reference library (smn-ailab/PyCMF) import ``from pycmf
import CMF``; this shim lets that line work unchanged against the
JAX rebuild. It re-exports the public surface of :mod:`pycmf_tpu` — the
estimator carries the full reference kwarg set (SURVEY.md §1) plus this
build's extras (``n_shards``, ``data_dtype``, ...), all defaulted so
reference-style call sites run as-is.

This package contains no implementation: everything lives in
``pycmf_tpu``.
"""
from pycmf_tpu import CMF, CsrMatrix, SolverConfig, make_hyper  # noqa: F401
from pycmf_tpu import __version__  # noqa: F401
from pycmf_tpu.utils import analysis  # noqa: F401
from pycmf_tpu.utils.analysis import (  # noqa: F401
    top_component_samples,
    top_terms_per_component,
    topic_terms_string,
)

__all__ = [
    "CMF", "CsrMatrix", "SolverConfig", "make_hyper", "analysis",
    "top_terms_per_component", "topic_terms_string",
    "top_component_samples", "__version__",
]
