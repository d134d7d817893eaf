"""Test configuration (SURVEY.md §4 test plan).

Tests run on the CPU backend with 8 virtual devices so the sharded
(multi-chip) paths are exercised without a pod (SURVEY.md §4d), and with
x64 enabled so parity tests can run in float64 (SURVEY.md §7 hard part #1).
These env vars must be set before jax is imported anywhere.
"""
import os

# Never attempt the 20NG network download inside the suite — the no-network
# environment would burn ~35 s of retries per run (bench.py still attempts).
os.environ.setdefault("PYCMF_NO_DOWNLOAD", "1")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# XLA:CPU segfault mitigation #1 (see pytest_collection_modifyitems for
# the history): raise the stack rlimit BEFORE the backend spawns its
# thread pools — glibc sizes default pthread stacks from the soft limit
# at thread-creation time, and LLVM's instruction selection recurses
# deeply on the suite's largest forced-CPU shard_map modules. 8 MiB
# (the usual default) is marginal; 512 MiB costs nothing (virtual
# reservation) on this 128 GB host.
import resource  # noqa: E402

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
_want = 512 * (1 << 20)
if _soft != resource.RLIM_INFINITY and _soft < _want:
    try:
        resource.setrlimit(resource.RLIMIT_STACK, (
            _want if _hard == resource.RLIM_INFINITY else min(_want, _hard),
            _hard))
    except (ValueError, OSError):
        pass

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# The suite never enables the persistent compile cache
# (pycmf_tpu.utils.cache): XLA:CPU's executable (de)serializer segfaulted
# non-deterministically on the large forced-CPU shard_map executables
# near the end of the suite. Recompiling every run costs wall time but
# cannot crash the run.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Run test_sparse_y first. Its rows-sharded chunked-Y fits compile
    the largest forced-CPU shard_map executables in the suite, and XLA:CPU
    segfaulted three times (in compile, executable.serialize, and
    deserialize_executable — all native, uncatchable) when those compiles
    landed ~88% into the full suite, while the same tests pass reliably
    (4/4) in a fresh process. Hoisting them to the front runs the fragile
    compiles in the proven-stable process state; the stable sort keeps
    every other file in its usual order."""
    items.sort(key=lambda it: 0 if "test_sparse_y" in str(it.fspath) else 1)


# XLA:CPU segfault mitigation #2: the crash correlates with process age
# (hundreds of live compiled executables), not with any specific test —
# the same compiles pass in a fresh process. Dropping the in-memory
# executable caches every ~120 items bounds the accumulated native state
# the way the fuzzer's every-25-case clear does (commit d640ee7), at the
# cost of a few intra-module recompiles.
_CLEAR_EVERY = 120
_test_counter = {"n": 0}


def pytest_runtest_teardown(item, nextitem):
    _test_counter["n"] += 1
    if nextitem is not None and _test_counter["n"] % _CLEAR_EVERY == 0:
        jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.RandomState(42)


def make_problem(rng, n=60, m=40, r=10, k=4, noise=0.01, non_negative=True,
                 sparse=False, binary_y=False):
    """Small synthetic CMF problem with known low-rank structure."""
    import scipy.sparse as sp

    Ut = rng.randn(n, k)
    Vt = rng.randn(m, k)
    Zt = rng.randn(r, k)
    if non_negative:
        Ut, Vt, Zt = np.abs(Ut), np.abs(Vt), np.abs(Zt)
    X = Ut @ Vt.T + noise * rng.randn(n, m)
    Y = Vt @ Zt.T + noise * rng.randn(m, r)
    if non_negative:
        X = np.abs(X)
        Y = np.abs(Y)
    if binary_y:
        Y = (1.0 / (1.0 + np.exp(-(Vt @ Zt.T))) > 0.5).astype(float)
    if sparse:
        Xd = X.copy()
        thresh = np.quantile(Xd, 0.7)
        Xd[Xd < thresh] = 0.0
        X = sp.csr_matrix(Xd)
    return X, Y


@pytest.fixture
def problem(rng):
    return make_problem(rng)
