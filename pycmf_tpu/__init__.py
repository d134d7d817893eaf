"""pycmf_tpu — Collective Matrix Factorization in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of smn-ailab/PyCMF
(see SURVEY.md): jointly factor X ≈ f_x(U Vᵀ) and Y ≈ f_y(V Zᵀ) with a
shared V, behind a scikit-learn-style estimator.

Layers (SURVEY.md §1 layer map):
  models.CMF        — sklearn-compatible estimator (NumPy in/out)
  solvers           — pure jitted MU + batched Newton steps
  ops               — links, losses, sparse SpMM and chunked streaming
  parallel          — rows / cols / grid sharding over a device mesh
  utils             — init, validation, analysis, checkpoint, profiling
"""
from .models.cmf import CMF
from .ops.sparse import CsrMatrix
from .solvers.common import SolverConfig, make_hyper

__version__ = "0.1.0"
__all__ = ["CMF", "CsrMatrix", "SolverConfig", "make_hyper", "__version__"]
