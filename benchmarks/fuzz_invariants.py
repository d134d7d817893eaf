"""Randomized invariant fuzzer: cross-path properties the config fuzzer
(fuzz_configs.py) does not cover.

Per random case (the shared generator in fuzz_common.py) it checks, at
f64 on the CPU backend:

1. loop='device' matches loop='host' (same config, same init) — the
   device-resident while_loop and the host tol loop share one RNG
   schedule and must produce identical trajectories (rtol 1e-9).
2. warm-start resume: fit(max_iter=4) == fit(max_iter=2) then a second
   fit warm-started from the stored factors for 2 more (full-batch only:
   a resumed fit re-seeds the sampling RNG by design, so sampled
   trajectories legitimately differ across the split).
3. eval-cadence independence: with tol=0, eval_every=1 vs 3 must not
   change the factors (loss evaluation is observation, not state).
4. transform parity: fold-in on fresh rows (explicit U0) matches between
   the sharded and single-device models fitted from the same init.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/fuzz_invariants.py <seed> <n_cases>
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from fuzz_common import draw_case
from pycmf_tpu import CMF

seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
N = int(sys.argv[2]) if len(sys.argv) > 2 else 40
rng = np.random.RandomState(seed)
fails = 0


def close(a, b, rtol=1e-9, atol=1e-12):
    return np.allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


for t in range(N):
    if t and t % 25 == 0:
        jax.clear_caches()  # bound LLVM JIT memory (see fuzz_configs.py)
    c = draw_case(rng)
    X, Y, U0, V0, Z0 = c["X"], c["Y"], c["U0"], c["V0"], c["Z0"]
    kw = dict(random_state=7, **c["kw"], **c["skw"])
    desc = f"[{t}] {c['desc']}"
    try:
        base = CMF(max_iter=4, **kw)
        base.fit(X, Y, U=U0, V=V0, Z=Z0)

        # 1. device loop == host loop
        dev = CMF(max_iter=4, loop="device", **kw)
        dev.fit(X, Y, U=U0, V=V0, Z=Z0)
        hst = CMF(max_iter=4, loop="host", **kw)
        hst.fit(X, Y, U=U0, V=V0, Z=Z0)
        if not (close(dev.U_, hst.U_) and close(dev.V_, hst.V_)):
            print("LOOP-MISMATCH", desc,
                  np.max(np.abs(np.asarray(dev.U_) - np.asarray(hst.U_))),
                  flush=True)
            fails += 1
            continue

        # 2. warm-start resume (full-batch only)
        if c["sr"] >= 1.0:
            half = CMF(max_iter=2, **kw)
            half.fit(X, Y, U=U0, V=V0, Z=Z0)
            res = CMF(max_iter=2, **kw)
            res.fit(X, Y, U=np.asarray(half.U_), V=np.asarray(half.V_),
                    Z=None if Z0 is None else np.asarray(half.Z_))
            if not (close(res.U_, base.U_, 1e-7, 1e-10)
                    and close(res.V_, base.V_, 1e-7, 1e-10)):
                print("RESUME-MISMATCH", desc,
                      np.max(np.abs(np.asarray(res.U_)
                                    - np.asarray(base.U_))), flush=True)
                fails += 1
                continue

        # 3. eval-cadence independence at tol=0
        ev = CMF(max_iter=4, eval_every=3, **kw)
        ev.fit(X, Y, U=U0, V=V0, Z=Z0)
        if not (close(ev.U_, base.U_) and close(ev.V_, base.V_)):
            print("CADENCE-MISMATCH", desc,
                  np.max(np.abs(np.asarray(ev.U_) - np.asarray(base.U_))),
                  flush=True)
            fails += 1
            continue

        # 4. transform parity (sharded vs single)
        n2 = int(rng.choice([2, 7, 13]))
        m = V0.shape[0]
        X2 = np.abs(rng.randn(n2, m))
        if c["kw"]["x_link"] == "sigmoid":
            X2 = (X2 > np.median(X2)).astype(float)
        U2 = np.abs(rng.randn(n2, U0.shape[1]))
        tp = base.transform(X2, U=U2)
        if c["lay"] != "none" and c["sr"] >= 1.0:
            single = CMF(max_iter=4,
                         **{k: v for k, v in kw.items()
                            if k not in ("n_shards", "shard_layout")})
            single.fit(X, Y, U=U0, V=V0, Z=Z0)
            ts = single.transform(X2, U=U2)
            if not close(tp, ts, 1e-6, 1e-8):
                print("TRANSFORM-SHARD-MISMATCH", desc,
                      np.max(np.abs(np.asarray(tp) - np.asarray(ts))),
                      flush=True)
                fails += 1
                continue
        print("ok", desc, flush=True)
    except Exception as e:  # noqa: BLE001
        print("ERROR", desc, "->", type(e).__name__, str(e)[:200],
              flush=True)
        fails += 1
print("FAILS:", fails, "/", N, flush=True)
