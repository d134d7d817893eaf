"""Smoke test of the CMF main path on NVIDIA GPUs, at the full 20NG shape.

Drives ``CMF.fit`` / ``CMF.transform`` the way a user does, on the
20NG-shaped supervised-topic problem (X: 30000 terms x 11314 documents,
~873,651 nonzeros; Y: 11314 x 20 one-hot; k = 20) generated from a seed,
and compares every result with the float64 NumPy reference
(baselines/numpy_cmf.py) from the same initial factors.

    python chip_smoke.py               # one GPU: phases 0-5
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

Phases (one card): 0 device and versions, 1 MU fit (f32 and bf16 data),
2 Newton fit (linear X, sigmoid Y), 3 sparse layouts (csr, chunked) against
dense, 4 fold-in, 5 host loop against device loop, with the MU step's time
beside one and two X passes at a copy bandwidth measured in the same run.
With --four-cards: rows-layout MU, rows-layout Newton with sigmoid Y and
2x2 grid MU, each against the single-card fit of the same problem.

Every phase prints its numbers on its own lines; a check outside its bound
raises and ends the script nonzero. Without a GPU it exits nonzero and
prints no result. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

K = 20
SEED = 0
N_MU = 50       # MU iterations of the fits and of their float64 reference
N_NEWTON = 10   # Newton iterations, likewise
N_SPARSE = 10   # iterations of the layout comparisons
N_FOLD = 30     # fold-in iterations
N_FOLD_ROWS = 1000
N_FOUR = 20     # iterations of each four-card fit

# Relative objective gaps allowed against the reference, with the reason
# for each bound. "f32" means float32 data and factors with every dot at
# Precision.HIGHEST (true float32 on the GPU, not TF32).
BOUNDS = {
    "mu/float32": (1e-4, "f32 at HIGHEST: only the accumulation order of "
                         "the length-11314 and length-30000 sums differs "
                         "from float64"),
    "mu/bfloat16": (2e-3, "bf16 data: X's counts are exact in bf16, but "
                          "each data-pass dot rounds the factor operand to "
                          "bf16 (8 significant bits, ops/matmul.py)"),
    "newton/float32": (1e-3, "f32 at HIGHEST; the backtracking line search "
                             "compares f32 objectives, so a near-tie can "
                             "take a different step than float64 does"),
    "newton/bfloat16": (5e-3, "bf16 factor operand in the data passes "
                              "(as mu/bfloat16) on top of the line-search "
                              "near-ties (as newton/float32)"),
    "layout": (1e-5, "csr and chunked compute the same f32 sums as dense "
                     "in another order"),
    "fold_in": (1e-4, "f32 at HIGHEST against the float64 fold-in; same "
                      "reason as mu/float32"),
    "four_cards": (1e-4, "the psum over four cards sums the same f32 "
                         "terms as one card in another order"),
}


class SmokeFailure(AssertionError):
    """A compared quantity is outside its bound (or not finite)."""


def require_gpu(devices) -> None:
    """Exit nonzero unless JAX's devices are GPUs (no CPU fallback)."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {platform!r}",
              file=sys.stderr)
        sys.exit(2)


def check(name: str, value: float, bound_key: str) -> None:
    """Print `value` beside its bound and raise SmokeFailure past it."""
    bound, reason = BOUNDS[bound_key]
    ok = bool(np.isfinite(value)) and value <= bound
    print(f"  {name}: {value:.3e} (bound {bound:g}: {reason}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{name} = {value!r} exceeds {bound:g}")


def rel_gap(value: float, ref: float) -> float:
    return abs(value - ref) / abs(ref)


def result_line(devices) -> str:
    """The last line of stdout."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def select_phases(argv=None):
    """Phase names to run, in order, from the command line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded paths and what "
                         "they are compared with")
    args = ap.parse_args(argv)
    if args.four_cards:
        return ["device", "four_cards"]
    return ["device", "mu", "newton", "layouts", "fold_in", "loop"]


def memory_stat(device, key: str) -> int:
    return device.memory_stats()[key]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


class Ctx:
    """The problem, its float64 copy and the seeded initial factors."""

    def __init__(self):
        from pycmf_tpu.utils.datasets import synthetic_20ng
        from pycmf_tpu.utils.init import initialize_factors

        self.X, self.Y = synthetic_20ng(random_state=SEED)
        self.X64 = self.X.astype(np.float64)
        self.Y64 = self.Y.astype(np.float64)
        self.inits = initialize_factors(self.X, self.Y, K,
                                        random_state=SEED)
        n, m = self.X.shape
        print(f"  data: X {n}x{m} nnz={self.X.nnz} "
              f"({self.X.nnz / (n * m):.4%}), Y {self.Y.shape}, k={K}",
              flush=True)

    def fit(self, **kw):
        """(model, wall seconds) of one estimator fit from the inits."""
        from pycmf_tpu import CMF

        U0, V0, Z0 = self.inits
        m = CMF(n_components=K, random_state=SEED, tol=0.0, **kw)
        t0 = time.perf_counter()
        m.fit(self.X, self.Y, U=U0, V=V0, Z=Z0)
        return m, time.perf_counter() - t0

    def loss(self, m, y_link="linear"):
        from baselines import numpy_cmf

        return numpy_cmf.loss(self.X64, self.Y64, m.U_, m.V_, m.Z_,
                              y_link=y_link)


def phase_device(ctx):
    import jax
    import jaxlib
    from importlib import metadata

    from pycmf_tpu.utils.cache import enable_persistent_cache

    print(nvidia_smi(), flush=True)
    plugins = []
    for dist in ("jax-cuda12-plugin", "jax-cuda13-plugin"):
        try:
            plugins.append(f"{dist} {metadata.version(dist)}")
        except metadata.PackageNotFoundError:
            pass
    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"cuda plugin: {', '.join(plugins) or 'none found'}", flush=True)
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"compile cache: {enable_persistent_cache()}", flush=True)
    print(f"  devices: {[str(d) for d in jax.devices()]}", flush=True)


def _fixed_count(n):
    # one eval block of n iterations: a fixed count, whatever tol would do
    return dict(max_iter=n, eval_every=n)


def phase_mu(ctx):
    from baselines import numpy_cmf

    U0, V0, Z0 = ctx.inits
    ref = numpy_cmf.run_mu(ctx.X64, ctx.Y64, U0.copy(), V0.copy(),
                           Z0.copy(), max_iter=N_MU, tol=0.0,
                           eval_every=N_MU)
    L_ref = numpy_cmf.loss(ctx.X64, ctx.Y64, *ref[:3])
    print(f"  float64 reference: {N_MU} iterations, loss {L_ref:.10g}",
          flush=True)
    for dd in ("float32", "bfloat16"):
        m, t_cold = ctx.fit(solver="mu", data_dtype=dd, **_fixed_count(N_MU))
        m, t_warm = ctx.fit(solver="mu", data_dtype=dd, **_fixed_count(N_MU))
        solve = sum(m.step_times_)
        print(f"  mu {dd}: {m.n_iter_} iterations, loss "
              f"{ctx.loss(m):.10g}, warm solve {solve / N_MU * 1e3:.4f} "
              f"ms/iter (fit wall {t_warm:.3f} s), compile "
              f"{t_cold - t_warm:.2f} s", flush=True)
        if m.n_iter_ != N_MU:
            raise SmokeFailure(f"mu {dd} ran {m.n_iter_} iterations")
        check(f"mu {dd} objective gap vs float64", rel_gap(ctx.loss(m),
                                                           L_ref),
              f"mu/{dd}")
        if dd == "float32":
            ctx.mu_model = m


def phase_newton(ctx):
    from baselines import numpy_cmf

    U0, V0, Z0 = ctx.inits
    ref = numpy_cmf.run_newton(ctx.X64, ctx.Y64, U0.copy(), V0.copy(),
                               Z0.copy(), max_iter=N_NEWTON, tol=0.0,
                               eval_every=N_NEWTON, y_link="sigmoid",
                               non_negative=(True, True, True))
    L_ref = numpy_cmf.loss(ctx.X64, ctx.Y64, *ref[:3], y_link="sigmoid")
    print(f"  float64 reference: {N_NEWTON} iterations, loss {L_ref:.10g}",
          flush=True)
    for dd in ("float32", "bfloat16"):
        kw = dict(solver="newton", y_link="sigmoid", data_dtype=dd,
                  **_fixed_count(N_NEWTON))
        m, t_cold = ctx.fit(**kw)
        m, t_warm = ctx.fit(**kw)
        L = ctx.loss(m, "sigmoid")
        print(f"  newton {dd}: {m.n_iter_} iterations, loss {L:.10g}, "
              f"warm solve {sum(m.step_times_) / N_NEWTON * 1e3:.4f} "
              f"ms/iter (fit wall {t_warm:.3f} s), compile "
              f"{t_cold - t_warm:.2f} s", flush=True)
        check(f"newton {dd} objective gap vs float64", rel_gap(L, L_ref),
              f"newton/{dd}")


def phase_layouts(ctx):
    dense, _ = ctx.fit(solver="mu", sparse_mode="dense",
                       **_fixed_count(N_SPARSE))
    L_dense = ctx.loss(dense)
    for mode in ("csr", "chunked"):
        m, _ = ctx.fit(solver="mu", sparse_mode=mode,
                       **_fixed_count(N_SPARSE))
        m, _ = ctx.fit(solver="mu", sparse_mode=mode,
                       **_fixed_count(N_SPARSE))
        du = np.max(np.abs(m.U_ - dense.U_)) / np.max(np.abs(dense.U_))
        print(f"  mu {mode}: warm solve "
              f"{sum(m.step_times_) / N_SPARSE * 1e3:.4f} ms/iter, "
              f"max |dU| / max |U| = {du:.3e}", flush=True)
        check(f"{mode} vs dense objective gap", rel_gap(ctx.loss(m),
                                                        L_dense), "layout")


def phase_fold_in(ctx):
    from baselines import numpy_cmf

    m = ctx.mu_model
    Xn = ctx.X[:N_FOLD_ROWS]
    rng = np.random.RandomState(SEED + 1)
    U0 = np.abs(rng.standard_normal((N_FOLD_ROWS, K))) * np.sqrt(
        Xn.mean() / K)
    m.set_params(tol=0.0, **_fixed_count(N_FOLD))
    t0 = time.perf_counter()
    U = m.transform(Xn, U=U0)
    t = time.perf_counter() - t0
    Xn64 = ctx.X64[:N_FOLD_ROWS]
    U_ref = numpy_cmf.fold_in_mu(Xn64, m.V_, U0.copy(), n_iter=N_FOLD)

    def obj(Uf):
        return numpy_cmf.loss(Xn64, None, Uf, m.V_, None)

    du = np.max(np.abs(U - U_ref)) / np.max(np.abs(U_ref))
    print(f"  transform of {N_FOLD_ROWS} rows, {N_FOLD} iterations: "
          f"{t:.3f} s wall (first call, compile included), "
          f"max |dU| / max |U| = {du:.3e}", flush=True)
    check("fold-in objective gap vs float64", rel_gap(obj(U), obj(U_ref)),
          "fold_in")


def _time_device(fn, reps=10):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_loop(ctx):
    """Host loop against device loop on the bf16 MU fit (the estimator's
    loop='auto' on a GPU follows this measurement), then the MU step
    beside one and two X passes."""
    import jax
    import jax.numpy as jnp

    from bench import peak_bytes_per_s
    from pycmf_tpu.ops.matmul import matmul
    from pycmf_tpu.solvers.common import SolverConfig, make_hyper
    from pycmf_tpu.solvers.mu import run_mu
    from pycmf_tpu.utils.validation import as_coupled

    Xc = as_coupled(ctx.X, jnp.bfloat16)
    Yc = as_coupled(ctx.Y, jnp.bfloat16)
    U0, V0, Z0 = (jnp.asarray(a, jnp.float32) for a in ctx.inits)
    cfg, hyper = SolverConfig(), make_hyper(dtype=jnp.float32)

    def run(loop):
        out = run_mu(Xc, Yc, U0, V0, Z0, cfg, hyper, max_iter=N_MU,
                     tol=0.0, eval_every=10, loop=loop)
        jax.block_until_ready(out[:3])
        return out

    times = {"host": [], "device": []}
    for loop in ("host", "device"):
        run(loop)                       # compile
    for order in (("host", "device"), ("device", "host"),
                  ("host", "device"), ("device", "host")):
        for loop in order:
            t0 = time.perf_counter()
            n_iter = run(loop)[3]
            times[loop].append((time.perf_counter() - t0) / n_iter)
    for loop, ts in times.items():
        print(f"  loop={loop}: median {np.median(ts) * 1e3:.4f} ms/iter "
              f"over {len(ts)} fits ({[round(t * 1e3, 4) for t in ts]})",
              flush=True)

    # XLA's MU step beside the X passes it is made of
    X = Xc.A
    Uj = jax.random.uniform(jax.random.PRNGKey(0), (X.shape[0], K))
    Vj = jax.random.uniform(jax.random.PRNGKey(1), (X.shape[1], K))
    big = jnp.ones((1 << 28,), jnp.float32)          # 1 GiB
    add1 = jax.jit(lambda a: a + 1.0)
    copy_bw = 2 * big.nbytes / _time_device(lambda: add1(big))  # r + w
    one = jax.jit(lambda X, V: matmul(X, V))
    two = jax.jit(lambda X, V, U: (matmul(X, V), matmul(X.T, U)))
    t_one = _time_device(lambda: one(X, Vj))
    t_two = _time_device(lambda: two(X, Vj, Uj))
    step = np.median(times["device"])
    peak = peak_bytes_per_s(jax.devices()[0].device_kind)
    xb = X.nbytes
    print(f"  copy bandwidth {copy_bw / 1e12:.3f} TB/s "
          f"({copy_bw / peak:.1%} of the {peak / 1e12:.2f} TB/s data-sheet "
          f"peak); X bf16 {xb / 1e6:.1f} MB: one pass at copy bandwidth "
          f"{xb / copy_bw * 1e3:.4f} ms, two {2 * xb / copy_bw * 1e3:.4f} ms",
          flush=True)
    print(f"  XLA X.V {t_one * 1e3:.4f} ms, X.V + X^T.U {t_two * 1e3:.4f} "
          f"ms, MU step (device loop, Y and loss included) "
          f"{step * 1e3:.4f} ms/iter", flush=True)


def phase_four_cards(ctx):
    import jax
    import jax.numpy as jnp

    from pycmf_tpu.parallel.mesh import make_mesh
    from pycmf_tpu.parallel.sharded import (_prepare_rows,
                                            _shard_specs_rows,
                                            place_operands)

    devs = jax.devices()
    if len(devs) != 4:
        raise SmokeFailure(f"--four-cards needs 4 GPUs, found {len(devs)}")

    # the shards must sit on four distinct cards, not all on the first:
    # the dense f32 X the rows-layout fits below use, placed as they are
    before = [memory_stat(d, "bytes_in_use") for d in devs]
    ops, _, _ = _prepare_rows(ctx.X.toarray(), ctx.Y, ctx.inits[0], 4,
                              jnp.float32)
    ops = place_operands(ops, _shard_specs_rows(ops), make_mesh(4))
    jax.block_until_ready(ops)
    after = [memory_stat(d, "bytes_in_use") for d in devs]
    grown = [a - b for a, b in zip(after, before)]
    shard_bytes = ops.X.nbytes // 4
    print(f"  rows-layout dense X placed: device_set "
          f"{sorted(d.id for d in ops.X.sharding.device_set)}, bytes in use "
          f"per card {after}, growth {grown} (one X shard "
          f"{shard_bytes} bytes)", flush=True)
    if len(ops.X.sharding.device_set) != 4 or \
            min(grown) < shard_bytes // 2:
        raise SmokeFailure("X's shards are not spread over four cards")
    del ops

    cases = [
        ("rows mu", dict(solver="mu"), dict(n_shards=4), "linear"),
        ("rows newton sigmoid-Y", dict(solver="newton", y_link="sigmoid"),
         dict(n_shards=4), "sigmoid"),
        ("grid 2x2 mu", dict(solver="mu"),
         dict(n_shards=(2, 2), shard_layout="grid"), "linear"),
    ]
    for name, kw, shard_kw, y_link in cases:
        # second fits are warm: the first of each compiles
        ctx.fit(**kw, **_fixed_count(N_FOUR))
        one, _ = ctx.fit(**kw, **_fixed_count(N_FOUR))
        ctx.fit(**kw, **shard_kw, **_fixed_count(N_FOUR))
        four, _ = ctx.fit(**kw, **shard_kw, **_fixed_count(N_FOUR))
        peaks = [memory_stat(d, "peak_bytes_in_use") for d in devs]
        L1, L4 = ctx.loss(one, y_link), ctx.loss(four, y_link)
        du = np.max(np.abs(four.U_ - one.U_)) / np.max(np.abs(one.U_))
        print(f"  {name}: 4-card warm solve "
              f"{sum(four.step_times_) / N_FOUR * 1e3:.4f} ms/iter, 1-card "
              f"{sum(one.step_times_) / N_FOUR * 1e3:.4f} ms/iter, loss "
              f"{L4:.10g} vs {L1:.10g}, max |dU| / max |U| = {du:.3e}, "
              f"peak bytes in use per card so far {peaks}", flush=True)
        check(f"{name} 4-card vs 1-card objective gap", rel_gap(L4, L1),
              "four_cards")


PHASES = {
    "device": phase_device,
    "mu": phase_mu,
    "newton": phase_newton,
    "layouts": phase_layouts,
    "fold_in": phase_fold_in,
    "loop": phase_loop,
    "four_cards": phase_four_cards,
}


def main(argv=None) -> None:
    phases = select_phases(argv)
    import jax

    require_gpu(jax.devices())
    ctx = None
    for name in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        if name != "device" and ctx is None:
            ctx = Ctx()
        PHASES[name](ctx)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(result_line(jax.devices()), flush=True)


if __name__ == "__main__":
    main()
