"""Pod-scale CMF: row-sharded X/U over a device mesh with shared-V
all-reduce (BASELINE.json config #5).

On one host of GPUs the collectives run over NVLink; on a dev box, launch
with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/pod_scale_sharded.py --cpu
to simulate 8 devices.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import sys
import time

import numpy as np


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from pycmf_tpu import CMF
    from pycmf_tpu.utils.cache import enable_persistent_cache

    # the persistent compile cache turns re-runs' compiles into disk hits
    enable_persistent_cache()

    d = len(jax.devices())
    print(f"devices: {d} × {jax.devices()[0].platform}")

    rng = np.random.RandomState(0)
    n, m, r, k = 8192, 1024, 128, 16
    X = np.abs(rng.randn(n, m)).astype(np.float32)
    Y = np.abs(rng.randn(m, r)).astype(np.float32)

    single = CMF(n_components=k, solver="mu", random_state=0, max_iter=50,
                 tol=0.0)
    t0 = time.time()
    single.fit(X, Y)
    t_single = time.time() - t0

    sharded = CMF(n_components=k, solver="mu", random_state=0, max_iter=50,
                  tol=0.0, n_shards=d, shard_layout="rows")
    t0 = time.time()
    sharded.fit(X, Y)
    t_sharded = time.time() - t0

    gap = abs(single.reconstruction_err_ - sharded.reconstruction_err_)
    print(f"single-device: {t_single:.2f}s, loss {single.reconstruction_err_:.6g}")
    print(f"{d}-way sharded: {t_sharded:.2f}s, loss {sharded.reconstruction_err_:.6g}")
    print(f"|loss gap| = {gap:.3g} (sharded psum ≡ same sum, fp-order only)")

    # 2-D grid layout: X sharded over BOTH mesh axes (for problems
    # jointly huge in n and m, where neither 1-D layout's replicated
    # factor fits a chip) — each factor psums over the other axis only.
    if d >= 4 and d % 2 == 0:
        grid = CMF(n_components=k, solver="mu", random_state=0,
                   max_iter=50, tol=0.0, n_shards=(2, d // 2),
                   shard_layout="grid")
        t0 = time.time()
        grid.fit(X, Y)
        t_grid = time.time() - t0
        ggap = abs(single.reconstruction_err_ - grid.reconstruction_err_)
        print(f"2x{d // 2} grid: {t_grid:.2f}s, "
              f"loss {grid.reconstruction_err_:.6g} (|gap| {ggap:.3g})")

    # sharded fold-in: transform() uses the same mesh (V replicated)
    U_new = sharded.transform(X[:256])
    print(f"sharded transform fold-in: {U_new.shape}")


if __name__ == "__main__":
    main()
