"""The in-house estimator protocol (models/base.py): sklearn-style
get_params / set_params without importing scikit-learn, compatible with
sklearn's clone and Pipeline where sklearn is installed."""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from pycmf_tpu import CMF

# one non-default value per constructor parameter
NEW_VALUES = {
    "n_components": 7, "solver": "newton", "alpha": 0.3, "l1_ratio": 0.25,
    "tol": 1e-6, "max_iter": 17, "random_state": 5, "verbose": 1,
    "U_non_negative": False, "V_non_negative": False,
    "Z_non_negative": False, "x_link": "sigmoid", "y_link": "sigmoid",
    "x_init": "nndsvd", "y_init": "svd", "hessian_pertubation": 0.7,
    "sg_sample_ratio": 0.5, "eps": 1e-8, "dtype": "float64",
    "eval_every": 3, "hessian_form": "full", "line_search_trials": 2,
    "n_shards": 4, "shard_layout": "cols", "sparse_mode": "csr",
    "loop": "device", "data_dtype": "bfloat16",
}


def test_every_constructor_parameter_is_covered():
    sig = inspect.signature(CMF.__init__)
    assert set(sig.parameters) - {"self"} == set(NEW_VALUES)
    assert set(CMF().get_params()) == set(NEW_VALUES)


@pytest.mark.parametrize("name", sorted(NEW_VALUES))
def test_set_get_round_trip(name):
    m = CMF()
    default = m.get_params()[name]
    assert m.set_params(**{name: NEW_VALUES[name]}) is m
    assert m.get_params()[name] == NEW_VALUES[name]
    assert getattr(m, name) == NEW_VALUES[name]
    # the other parameters keep their defaults
    others = {k: v for k, v in m.get_params().items() if k != name}
    assert others == {k: v for k, v in CMF().get_params().items()
                      if k != name}
    assert default != NEW_VALUES[name]


def test_unknown_parameter_raises():
    with pytest.raises(ValueError, match="invalid parameter"):
        CMF().set_params(n_component=3)


def test_repr_lists_parameters():
    r = repr(CMF(n_components=3, alpha=0.5))
    assert r.startswith("CMF(") and "n_components=3" in r and "alpha=0.5" in r


def test_sklearn_clone_is_unfitted_copy(rng):
    from sklearn.base import clone

    X = np.abs(rng.rand(12, 9))
    m = CMF(n_components=2, max_iter=3, random_state=0).fit(X)
    c = clone(m)
    assert c is not m and c.get_params() == m.get_params()
    assert not hasattr(c, "V_")


def test_sklearn_pipeline_fit_transform(rng):
    from sklearn.pipeline import Pipeline

    X = np.abs(rng.rand(30, 14))
    pipe = Pipeline([("cmf", CMF(n_components=3, max_iter=5,
                                 random_state=0))])
    pipe.fit(X)
    assert pipe.transform(X).shape == (30, 3)
    assert pipe.get_params()["cmf__n_components"] == 3
    pipe.set_params(cmf__alpha=0.2)
    assert pipe.named_steps["cmf"].alpha == 0.2


def test_import_and_fit_without_sklearn():
    """scikit-learn is optional: block it and use the package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np, pycmf_tpu\n"
        "from pycmf_tpu import CMF\n"
        "m = CMF(n_components=2, max_iter=3, random_state=0)\n"
        "m.fit(np.abs(np.random.RandomState(0).rand(8, 6)))\n"
        "assert m.get_params()['n_components'] == 2\n"
        "assert 'sklearn' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
