"""Randomized config fuzzer: reference and sharded-vs-single parity.

Draws random tiny problems across the full config space (the shared
generator in fuzz_common.py) and asserts, for full-batch fits, that the
single-device fit matches the float64 NumPy reference
(baselines/numpy_cmf.py, rtol 1e-7) and that the sharded run matches the
single-device run (rtol 1e-6). Sampled fits
(sg_sample_ratio < 1) skip the sharded comparison: per-shard sample
keys are folded with the shard index BY DESIGN, so sharded stochastic
trajectories differ from single-device (host-vs-device loop parity is
what's guaranteed — see tests/test_sharded.py::TestShardedDeviceLoop).

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/fuzz_configs.py <seed> <n_cases>
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from baselines import numpy_cmf
from fuzz_common import draw_case
from pycmf_tpu import CMF


def reference(c, max_iter):
    """(U, V) from the float64 NumPy reference, same inits and count."""
    kw = c["kw"]
    args = (c["X"], c["Y"], c["U0"].copy(), c["V0"].copy(),
            None if c["Z0"] is None else c["Z0"].copy())
    common = dict(max_iter=max_iter, tol=0.0, alpha=kw["alpha"],
                  l1_ratio=kw["l1_ratio"])
    if kw["solver"] == "mu":
        out = numpy_cmf.run_mu(*args, **common)
    else:
        nn = kw["U_non_negative"]
        out = numpy_cmf.run_newton(*args, x_link=kw["x_link"],
                                   y_link=kw["y_link"],
                                   non_negative=(nn, nn, nn), **common)
    return out[0], out[1]


seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
N = int(sys.argv[2]) if len(sys.argv) > 2 else 40
rng = np.random.RandomState(seed)
fails = 0
for t in range(N):
    if t and t % 25 == 0:
        # every case compiles fresh executables (unique shapes/configs);
        # unbounded in-process accumulation exhausts LLVM JIT allocation
        # around ~145 mixed 8-device cases ("LLVM compilation error:
        # Cannot allocate memory", then a crash) — drop them periodically
        jax.clear_caches()
    c = draw_case(rng)
    kw = dict(max_iter=4, **c["kw"])
    desc = f"[{t}] {c['desc']}"
    try:
        mp = CMF(**kw)
        mp.fit(c["X"], c["Y"], U=c["U0"], V=c["V0"], Z=c["Z0"])
        if c["sr"] >= 1.0:
            Ur, Vr = reference(c, kw["max_iter"])
            ok = (np.allclose(mp.U_, Ur, rtol=1e-7, atol=1e-9)
                  and np.allclose(mp.V_, Vr, rtol=1e-7, atol=1e-9))
            if not ok:
                print("REFERENCE-MISMATCH", desc,
                      np.max(np.abs(np.asarray(mp.U_) - Ur)), flush=True)
                fails += 1
                continue
        if c["lay"] != "none" and c["sr"] >= 1.0:
            ms = CMF(**c["skw"], **kw)
            ms.fit(c["X"], c["Y"], U=c["U0"], V=c["V0"], Z=c["Z0"])
            ok = (np.allclose(mp.U_, ms.U_, rtol=1e-6, atol=1e-8)
                  and np.allclose(mp.V_, ms.V_, rtol=1e-6, atol=1e-8))
            if not ok:
                print("SHARD-MISMATCH", desc,
                      np.max(np.abs(np.asarray(mp.U_) - np.asarray(ms.U_))),
                      flush=True)
                fails += 1
                continue
        print("ok", desc, flush=True)
    except Exception as e:  # noqa: BLE001
        print("ERROR", desc, "->", type(e).__name__, str(e)[:200],
              flush=True)
        fails += 1
print("FAILS:", fails, "/", N, flush=True)
