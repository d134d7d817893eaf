"""Benchmark: 20NG text+labels CMF time-to-tolerance on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Metric (BASELINE.json): "Time-to-tolerance (MU & Newton) on 20NG
text+labels CMF". The reported value is the GEOMEAN of the two solver
speedups, each measured time-to-tolerance from the same initialization with
the same stopping rule, with a 2% equal-final-loss guard per solver. The
baseline is baselines/numpy_cmf.py — a faithful *vectorized* NumPy
implementation of the reference's update rules (PyCMF itself is not
installable here; its per-row Python/numba loops are slower, so these
speedups are conservative lower bounds).

The corpus is the 20NG-shaped synthetic surrogate (utils/datasets.py
synthetic_20ng), generated from a seed. Timing covers the solver run with
data already resident (device memory for the GPU side, RAM for the CPU
side) and ends in ``block_until_ready``. The GPU side tries data_dtype
bfloat16 and float32 and reports the fastest variant passing the quality
guard. Every CPU baseline is timed 5x and every GPU fit 3x after warmup;
the minimum is reported, all draws are logged.

Refuses to run when JAX's backend is not a GPU.
Env: PYCMF_BENCH_SMALL=1 shrinks the problem for smoke runs.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

TOL = 1e-4
MAX_ITER = 200
EVAL_EVERY = 10
NEWTON_TOL = 1e-5
NEWTON_MAX_ITER = 50
NEWTON_EVAL = 5
K = 20
SEED = 0
QUALITY_BAR = 0.02

# Peak memory bandwidth in bytes/s by jax device_kind, from the vendor
# data sheet (NVIDIA H100 SXM5: 3.35 TB/s of HBM3). A device missing here
# is an error, never an assumed peak.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(device_kind: str) -> float:
    """Data-sheet memory bandwidth of ``device_kind``; unknown kinds raise."""
    try:
        return PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth recorded for device kind {device_kind!r}; "
            "add its data-sheet figure to PEAK_BYTES_PER_S") from None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX's first device is "
                 f"{dev.platform} ({dev.device_kind})")
    kind = dev.device_kind
    peak = peak_bytes_per_s(kind)

    from pycmf_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from baselines import numpy_cmf
    from pycmf_tpu import CMF
    from pycmf_tpu.solvers.common import SolverConfig, make_hyper
    from pycmf_tpu.solvers.mu import run_mu
    from pycmf_tpu.solvers.newton import run_newton
    from pycmf_tpu.utils.datasets import synthetic_20ng
    from pycmf_tpu.utils.init import initialize_factors
    from pycmf_tpu.utils.validation import as_coupled

    loop = CMF(loop="auto")._resolve_loop()
    log(f"device: {kind} x{len(jax.devices())}, loop={loop}")

    if os.environ.get("PYCMF_BENCH_SMALL", "0") == "1":
        X, Y = synthetic_20ng(n_docs=500, n_terms=2000, random_state=SEED)
        source = "small synthetic smoke"
    else:
        X, Y = synthetic_20ng(random_state=SEED)
        source = "synthetic 20NG-shaped"
    log(f"data: {source}; X {X.shape} nnz={X.nnz} "
        f"({X.nnz / (X.shape[0] * X.shape[1]):.3%}), Y {Y.shape}")

    U0, V0, Z0 = initialize_factors(
        X, Y, K, x_init="random", y_init="random", random_state=SEED)

    f32 = jnp.float32
    Ud = jnp.asarray(U0, f32)
    Vd = jnp.asarray(V0, f32)
    Zd = jnp.asarray(Z0, f32)
    hyperd = make_hyper(dtype=f32)
    jax.block_until_ready((Ud, Vd, Zd, hyperd))

    def solver_run(solver, Xc, Yc, cfg, max_iter, tol, eval_every):
        rng = jax.random.PRNGKey(SEED)
        runner = run_mu if solver == "mu" else run_newton
        args = (Xc, Yc, Ud, Vd, Zd, cfg, hyperd) + (() if solver == "mu"
                                                    else (rng,))
        out = runner(*args, max_iter=max_iter, tol=tol,
                     eval_every=eval_every, loop=loop)
        jax.block_until_ready(out[:3])
        return out

    def timed_min(fn, repeats):
        """Run fn() repeats times; return (min seconds, [all], last result)."""
        times, out = [], None
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return min(times), times, out

    def timed_best(solver, cfg, max_iter, tol, eval_every, ref_loss):
        """Upload once per dtype, warm-compile, time, guard quality.

        Returns (best_seconds, info) for the fastest dtype passing the
        quality guard: dtype name, iterations and element sizes."""
        best, info = None, None
        names = {jnp.float32: "f32", jnp.bfloat16: "bf16"}
        for dd in (jnp.bfloat16, jnp.float32):
            Xc = as_coupled(X, dd)
            Yc = as_coupled(Y, dd)
            # warm-up with the SAME static (max_iter, eval_every): jit is
            # keyed on them
            solver_run(solver, Xc, Yc, cfg, max_iter, tol, eval_every)
            t, reps, out = timed_min(
                lambda: solver_run(solver, Xc, Yc, cfg, max_iter, tol,
                                   eval_every), 3)
            n_iter, losses = out[3], out[4]
            gap = abs(losses[-1] - ref_loss) / ref_loss
            log(f"{kind} {solver}[{names[dd]}]: {n_iter} iters, {t:.4f}s "
                f"(min of {[round(r, 4) for r in reps]}), "
                f"loss {losses[-1]:.6g} (gap {gap:.3%})")
            if gap <= QUALITY_BAR:
                # bf16 runs first: once a dtype passes, the larger one
                # can only be slower
                best = t
                info = {"dtype": names[dd], "n_iter": int(n_iter),
                        "item": jnp.dtype(dd).itemsize}
                break
        return best, info

    # Data passes per iteration: MU reads X twice (X·V for U, Xᵀ·U_new
    # for V) and Y twice; the Newton mix (linear X, sigmoid Y) reads X
    # twice (X·V for U's gradient, Xᵀ·U for V's) and Y about four times
    # (G/H and line search for Z and for V's Y-term). Loss evaluations
    # add no passes for MU (aux loss) and one X pass per eval for Newton.
    PASSES = {"mu": (2.0, 2.0), "newton": (2.0, 4.0)}

    def util_fields(solver, t, inf):
        px, py = PASSES[solver]
        bpi = (px * X.shape[0] * X.shape[1] * inf["item"]
               + py * Y.shape[0] * Y.shape[1] * inf["item"])
        spi = t / max(1, inf["n_iter"])
        bps = bpi / spi
        return {
            f"{solver}_dtype": inf["dtype"],
            f"{solver}_n_iter": inf["n_iter"],
            f"{solver}_ms_per_iter": spi * 1e3,
            f"{solver}_bytes_per_iter": int(bpi),
            f"{solver}_achieved_gbps": bps / 1e9,
            f"{solver}_peak_bw_frac": bps / peak,
        }

    speedups = {}
    util = {}
    CPU_REPS = 5

    # ---- MU (binding baseline: dtype-matched f32 NumPy) -----------------
    t_np_mu, reps, out = timed_min(
        lambda: numpy_cmf.run_mu(
            X.astype(np.float32), Y.astype(np.float32),
            U0.astype(np.float32), V0.astype(np.float32),
            Z0.astype(np.float32), max_iter=MAX_ITER, tol=TOL,
            eval_every=EVAL_EVERY), CPU_REPS)
    log(f"numpy MU[f32]: {out[3]} iters, {t_np_mu:.3f}s "
        f"(min of {[round(r, 3) for r in reps]}), loss {out[4][-1]:.6g}")
    best, inf = timed_best("mu", SolverConfig(), MAX_ITER, TOL, EVAL_EVERY,
                           out[4][-1])
    if best is not None:
        speedups["mu"] = t_np_mu / best
        util.update(util_fields("mu", best, inf))
    else:
        log("MU quality guard failed for all dtypes")

    # ---- Newton (sigmoid-linked labels, same data) ----------------------
    t_np_nt, reps, out = timed_min(
        lambda: numpy_cmf.run_newton(
            X.astype(np.float64), Y.astype(np.float64), U0.copy(),
            V0.copy(), Z0.copy(), max_iter=NEWTON_MAX_ITER, tol=NEWTON_TOL,
            eval_every=NEWTON_EVAL, y_link="sigmoid",
            non_negative=(True, True, True)), CPU_REPS)
    log(f"numpy Newton: {out[3]} iters, {t_np_nt:.3f}s "
        f"(min of {[round(r, 3) for r in reps]}), loss {out[4][-1]:.6g}")
    best, inf = timed_best("newton", SolverConfig(y_link="sigmoid"),
                           NEWTON_MAX_ITER, NEWTON_TOL, NEWTON_EVAL,
                           out[4][-1])
    if best is not None:
        speedups["newton"] = t_np_nt / best
        util.update(util_fields("newton", best, inf))
    else:
        log("Newton quality guard failed for all dtypes")

    geo = (float(np.exp(np.mean(np.log(list(speedups.values())))))
           if speedups else 0.0)
    print(json.dumps({
        "metric": "20ng_mu_newton_time_to_tol_speedup_geomean",
        "value": geo,
        "unit": "x",
        "vs_baseline": geo,
        "mu_x": speedups.get("mu", 0.0),
        "newton_x": speedups.get("newton", 0.0),
        **util,
        "corpus": source,
        "device": {"platform": dev.platform, "kind": kind,
                   "count": len(jax.devices())},
        "protocol": "cpu=min-of-5, gpu=min-of-3 after warmup, each fit "
                    "ends in block_until_ready; mu baseline = numpy f32",
    }))


if __name__ == "__main__":
    main()
