"""Tests that need an NVIDIA GPU (marker ``gpu``; run them on a card with
``python -m pytest tests/ -m gpu``). Whether a card is present is decided
in the fixture; elsewhere they skip. The suite's own process is pinned to
the CPU (conftest.py), so each check runs in a child process to which JAX
gives the card."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
import numpy as np
import jax
from baselines import numpy_cmf
from pycmf_tpu import CMF

assert jax.devices()[0].platform == "gpu", jax.devices()
solver, n_iter = sys.argv[1], 20
rng = np.random.RandomState(0)
Ut, Vt, Zt = (np.abs(rng.randn(s, 5)) for s in (300, 200, 12))
X = Ut @ Vt.T + 0.01 * np.abs(rng.randn(300, 200))
Y = Vt @ Zt.T
if solver == "newton":
    Y = (Y > np.median(Y)).astype(float)
U0, V0, Z0 = (np.abs(rng.randn(s, 5)) for s in (300, 200, 12))
y_link = "sigmoid" if solver == "newton" else "linear"
m = CMF(n_components=5, solver=solver, y_link=y_link, tol=0.0,
        max_iter=n_iter, eval_every=n_iter).fit(X, Y, U=U0, V=V0, Z=Z0)
run = numpy_cmf.run_mu if solver == "mu" else numpy_cmf.run_newton
kw = {} if solver == "mu" else {"y_link": y_link}
U, V, Z, _, _ = run(X, Y, U0.copy(), V0.copy(), Z0.copy(), max_iter=n_iter,
                    tol=0.0, eval_every=n_iter, **kw)
L = numpy_cmf.loss(X, Y, m.U_, m.V_, m.Z_, y_link=y_link)
L_ref = numpy_cmf.loss(X, Y, U, V, Z, y_link=y_link)
gap = abs(L - L_ref) / L_ref
print(solver, "gap", gap)
# float32 at Precision.HIGHEST against float64; the bounds and their
# reasons are chip_smoke.py's (mu/float32, newton/float32)
import chip_smoke
assert gap < chip_smoke.BOUNDS[solver + "/float32"][0], gap
"""


@pytest.fixture
def gpu_env():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["mu", "newton"])
def test_fit_on_gpu_matches_reference(gpu_env, solver):
    out = subprocess.run([sys.executable, "-c", CHILD, solver], cwd=REPO,
                         env=gpu_env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
