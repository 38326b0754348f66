"""Benchmark: HadISST-scale archetypal analysis at the REFERENCE
experiment protocol.

Workload (BASELINE.md config 3, synthetic stand-in — the HadISST netCDF
is not shippable in this image): n_samples=1788 monthly maps x
n_features=16384 grid cells (rank-8 structure + noise, standardized),
k=6 archetypes, and the reference HadISST experiment protocol:
best-of-100 restarts with the dictionary solver capped at ONE SPG step
per outer iteration (reference bin/run_hadisst_aa_wrapper.sh:40-44
N_INIT=100; bin/run_hadisst_aa.py:165 dictionary max_iterations=1).
Stopping uses relative cost-delta 1e-5: the reference's absolute 1e-4
at this standardized cost scale (~4e3) is below float32 resolution, so
the relative criterion — the reference's own 'rel_delta_f' mode
(archetypal_analysis.py:190-195) — is the honest equivalent.  float32
on one NVIDIA GPU; the script fails without one.

Baseline: the same algorithm, same protocol, fully vectorized in NumPy
float64 (benchmarks/numpy_baseline.py — at least as fast as the
reference's threaded Numba kernels).  Its times were measured on the
previous 1-core host, not on the machine that runs this benchmark
(BASELINE_MEASURED.json; benchmarks/measure_config3_e2e.py): full runs
to tolerance over several independent seeds x restarts, scaled linearly
over the independent restart axis (restarts are independent by
construction, reference bin/run_hadisst_aa.py:158-174, so linear
scaling is exact in expectation).  The older reconstructed estimate
(Gram time + n_init * mean_outer_iterations * per-iteration tail
time) is kept as ``vs_baseline_reconstructed``.  For the other
configs' baselines see benchmarks/measure_baselines.py.

Also reported (BASELINE.md metric): structural alternating-update
GFLOP/s and its share of the card's published peak at the run's matmul
precision (benchmarks/flops.py — a documented lower bound), and the
standalone Gram matmul's rate at 'float32' and 'tensorfloat32'.

Prints one JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup}
"""

import json
import os
import sys
import time

import numpy as np

N_SAMPLES = 1788
N_FEATURES = 16384
K = 6
N_INIT = 100
TOL = 1e-5
MAX_ITER = 500
CRITERION = 'rel_delta_f'
DICT_MAX_ITERATIONS = 1   # reference HadISST protocol (run_hadisst_aa.py:165)
BASELINE_CAP_ITERS = 13
BASELINE_BURN_IN = 3
BASELINE_RUNS = 4
PROTOCOL = "hadisst_reference_protocol_v4_dict1_tail"
# Convergence-compaction round length and restart chunk for the headline
# run (parallel/restarts.py:aa_fit_restarts).  Neither value is yet
# derived from an H100 measurement.
COMPACT_ITERS = 32
RESTART_CHUNK = 25
# Weights-QP inner-iteration cap.  The inner loop early-exits, and
# block-coordinate descent warm-starts the next outer step regardless.
# DISCLOSED DEVIATION from the HadISST reference protocol: the
# reference's hadisst driver caps only the dictionary and leaves
# weights at the library default 1000 (bin/run_hadisst_aa.py:165; the
# max_iterations=1 weights cap is its jra55 protocol,
# bin/run_jra55_pca_aa.py:119-120), so the knob itself is a reference
# pattern but not this config's.  Every run re-costs the winner in
# float64 (cost_f64_audit below); the value is recorded in the output
# workload dict.
WEIGHTS_MAX_ITERATIONS = 25
# Weights-QP backend of the headline: the fused GPU kernel, which beat
# XLA end to end at this workload (PERF.md, "Weights-QP kernel").
WEIGHTS_BACKEND = 'pallas'
# Matmul precision for the HEADLINE RUN ONLY (the library default stays
# 'float32' — utils/precision.py).  On the H100 'tensorfloat32' runs the
# Gram-sized matmuls on the TF32 tensor cores; what that costs in fit
# quality and gains in time is not yet measured there (ROADMAP §1.6).
# Quality is audited, not assumed: the winner's factors are re-costed
# on the host in float64 every run (cost_f64_audit below).
HEADLINE_MATMUL_PRECISION = 'tensorfloat32'
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BASELINE_MEASURED.json")


def make_data(dtype):
    rng = np.random.RandomState(42)
    U = rng.standard_normal((N_SAMPLES, 8))
    V = rng.standard_normal((8, N_FEATURES))
    X = U @ V + 0.3 * rng.standard_normal((N_SAMPLES, N_FEATURES))
    X -= X.mean(axis=0)
    X /= X.std(axis=0) + 1e-12
    return X.astype(dtype)


def measure_baseline():
    """Measure the NumPy-baseline Gram + per-outer-iteration time.

    Protocol v4: ``BASELINE_RUNS`` independent restarts (distinct
    seeds), each capped at ``BASELINE_CAP_ITERS`` outer iterations with
    per-iteration wall times recorded; the first ``BASELINE_BURN_IN``
    iterations of every run are DISCARDED before aggregating.  The
    per-iteration cost decays strongly from a cold start (v3 measured
    9.2 s -> 1.5 s within one run: early QP solves start far from any
    fixed point and burn their iteration caps), so a head-inclusive
    mean over-charges the baseline — the ~168-iteration protocol runs
    overwhelmingly in the warm regime the tail represents.  The
    headline uses a 10%-trimmed mean of the pooled tail samples; the
    reported interval is the tail's [q10, q90] SPREAD (these samples
    trend and are autocorrelated — they are not i.i.d., so no CI is
    claimed), and ``per_iter_seconds_min`` (fastest observed iteration
    anywhere, burn-in included) remains the conservative bound.  Must
    be run on an idle host (1 core; concurrent load inflates all of
    it).
    """
    from benchmarks.numpy_baseline import aa_fit_numpy
    X = make_data(np.float64)

    gram_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        K_gram = X @ X.T
        gram_times.append(time.perf_counter() - t0)
        del K_gram

    runs = []
    all_iter_times = []
    tail_times = []
    for seed in range(BASELINE_RUNS):
        iter_times = []
        t0 = time.perf_counter()
        _, _, cost, n_iter = aa_fit_numpy(
            X, K, np.random.RandomState(seed), tolerance=TOL,
            max_iterations=BASELINE_CAP_ITERS,
            dict_iterations=DICT_MAX_ITERATIONS,
            stopping_criterion=CRITERION, iter_times=iter_times)
        tail = iter_times[BASELINE_BURN_IN:]
        runs.append({
            "seed": seed,
            "capped_run_seconds": time.perf_counter() - t0,
            "capped_iters": int(n_iter),
            "cost_at_cap": float(cost),
            "iter_times": [round(t, 3) for t in iter_times],
            "per_iter_tail_mean": float(np.mean(tail)),
            "per_iter_tail_std": float(np.std(tail)),
        })
        all_iter_times.extend(iter_times)
        tail_times.extend(tail)

    tail_sorted = np.sort(np.asarray(tail_times))
    trim = max(1, int(0.1 * tail_sorted.size))
    trimmed = tail_sorted[trim:-trim]
    per_iter = float(np.mean(trimmed))
    # Cross-run dispersion of the tail mean: the per-iteration spread is
    # wide because iterations alternate fast/slow (bimodal), but the
    # run-level means are tight — this is the honest uncertainty on the
    # reconstruction's per_iter factor.
    run_means = [r["per_iter_tail_mean"] for r in runs]
    return {
        "protocol": PROTOCOL,
        "baseline": "vectorized numpy float64 "
                    "(benchmarks/numpy_baseline.py)",
        "method": ("gram_seconds + n_init * mean_outer_iters * "
                   "per_iter_seconds; per-iteration time over %d "
                   "independent runs x %d capped outer iterations with "
                   "the first %d iterations of each run discarded "
                   "(cold-start decay) and a 10%%-trimmed mean of the "
                   "pooled tail; per_iter_seconds_spread is the tail's "
                   "[q10, q90] (a spread, not a CI — samples trend and "
                   "are autocorrelated), per_iter_seconds_min the "
                   "fastest observed iteration (conservative bound)"
                   % (BASELINE_RUNS, BASELINE_CAP_ITERS,
                      BASELINE_BURN_IN)),
        "workload": {"n_samples": N_SAMPLES, "n_features": N_FEATURES,
                     "k": K, "n_init": N_INIT, "tolerance": TOL,
                     "max_iterations": MAX_ITER,
                     "dict_max_iterations": DICT_MAX_ITERATIONS},
        "gram_seconds": float(np.mean(gram_times)),
        "gram_seconds_all": gram_times,
        "per_iter_seconds": per_iter,
        "per_iter_seconds_std": float(np.std(tail_sorted)),
        "per_iter_seconds_spread": [
            float(np.quantile(tail_sorted, 0.1)),
            float(np.quantile(tail_sorted, 0.9))],
        "per_iter_seconds_min": float(np.min(all_iter_times)),
        "per_iter_run_tail_means": [float(m) for m in run_means],
        "per_iter_run_means_mean": float(np.mean(run_means)),
        "per_iter_run_means_std": float(np.std(run_means, ddof=1)),
        "runs": runs,
        "host_cpus": os.cpu_count(),
    }


def measure_gram_throughput(X, reps=100, precision='float32'):
    """Standalone Gram matmul FLOP/s at a matmul ``precision``.

    Runs ``reps`` and ``2*reps`` Gram matmuls inside one compiled loop
    each and takes the slope, so dispatch and host overheads cancel and
    only per-matmul device time remains.  The loop-carried scalar
    perturbs the input each trip (no hoisting) and the reduce-max
    consumes every element of K (indexing one element would let XLA
    dead-code-eliminate the Gram down to a single dot row).  Returns
    ``(None, None)`` when noise makes the slope non-positive.
    """
    import functools
    import jax
    from jax import lax
    import jax.numpy as jnp
    from benchmarks.flops import gram_flops

    @functools.partial(jax.jit, static_argnums=1)
    def gram_reps(X, reps):
        def body(_, s):
            K = jnp.matmul(X * (1.0 + s), X.T, precision=precision)
            return jnp.max(jnp.abs(K)) * 1e-30
        return lax.fori_loop(0, reps, body, jnp.float32(0.0))

    times = {}
    for r in (reps, 2 * reps):
        float(gram_reps(X, r))  # compile + warm (fetch forces completion)
        t0 = time.perf_counter()
        float(gram_reps(X, r))
        times[r] = time.perf_counter() - t0
    seconds = (times[2 * reps] - times[reps]) / reps
    if seconds <= 0:
        return None, None
    return gram_flops(N_SAMPLES, N_FEATURES) / seconds, seconds


def card_line():
    """``name, power.limit`` of every GPU, as ``nvidia-smi`` reports
    them, read by a child process that does not import JAX."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def flagship_fit(X, backend=WEIGHTS_BACKEND, mesh=None, **overrides):
    """The headline workload: best-of-``N_INIT`` AA at the HadISST
    protocol (``parallel.restarts.aa_fit_restarts``) with convergence
    compaction, which runs the grouped restart structure (weights QP
    batched across restarts); ``overrides`` replace any of its keyword
    arguments."""
    import jax
    from convex_dim_red_tpu.parallel.restarts import aa_fit_restarts
    kwargs = dict(
        n_init=N_INIT, init='random', tolerance=TOL,
        max_iterations=MAX_ITER, stopping_criterion=CRITERION,
        dictionary_solver_kwargs={'max_iterations': DICT_MAX_ITERATIONS},
        weights_solver_kwargs={'max_iterations': WEIGHTS_MAX_ITERATIONS,
                               'backend': backend},
        restart_chunk=RESTART_CHUNK, compact_iterations=COMPACT_ITERS,
        mesh=mesh)
    kwargs.update(overrides)
    return aa_fit_restarts(X, K, jax.random.PRNGKey(0), **kwargs)


def audit_cost_f64(result, X32):
    """Recompute the winning restart's cost on host in float64.

    Guards the reduced-precision headline: the device cost is computed
    under HEADLINE_MATMUL_PRECISION, so it could in principle be biased
    by matmul noise; the audit re-costs the returned factors exactly
    (reference cost definition, archetypal_analysis.py:556 analog).
    """
    X64 = np.asarray(X32, np.float64)
    Z = np.asarray(result['weights'], np.float64)
    D = np.asarray(result['dictionary'], np.float64)
    resid = Z @ (D @ X64) - X64
    return 0.5 * float(np.sum(resid * resid)) / X64.shape[0]


def headline():
    """Run the headline measurement; returns the result dict.  The
    headline's matmul precision applies only for its duration."""
    from convex_dim_red_tpu.utils.precision import (get_matmul_precision,
                                                    set_matmul_precision)
    previous = get_matmul_precision()
    set_matmul_precision(HEADLINE_MATMUL_PRECISION)
    try:
        return _headline()
    finally:
        set_matmul_precision(previous)


def _headline():
    import jax
    from convex_dim_red_tpu.utils.cache import enable_compilation_cache
    from benchmarks.flops import (aa_outer_iteration_flops, gram_flops,
                                  peak_flops)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("bench.py needs a GPU; JAX reports platform %r"
                         % dev.platform)
    card = card_line()
    enable_compilation_cache()

    baseline = None
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            baseline = json.load(f)
        if baseline.get("protocol") != PROTOCOL:
            baseline = None  # stale protocol: re-measure
    if baseline is None:
        print("measuring numpy baseline (one-time)...", file=sys.stderr)
        baseline = measure_baseline()
        with open(BASELINE_FILE, "w") as f:
            json.dump(baseline, f, indent=2)

    X_host = make_data(np.float32)
    X = jax.device_put(X_host)
    jax.block_until_ready(X)

    # Warm-up: compile.
    t0 = time.perf_counter()
    jax.block_until_ready(flagship_fit(X)['weights'])
    compile_and_run = time.perf_counter() - t0

    # Steady-state measurement.
    t0 = time.perf_counter()
    result = flagship_fit(X)
    jax.block_until_ready(result['weights'])
    elapsed = time.perf_counter() - t0

    # Secondary metric: screened restarts (screen 50 iters -> keep the
    # best quarter -> resume).  A framework capability beyond the
    # reference protocol: the lockstep batch pays for its slowest
    # restart, so pruning after a bounded screening pass cuts the
    # straggler cost; the resumed winner's cost is audited below.
    def run_screened():
        # screen_margin guards the pruning heuristic: any restart within
        # 2.0 cost units (~0.05% of the objective) of the fractional
        # cut also survives, so a near-tied eventual winner cannot be
        # pruned by a hair; the screen diagnostics (cut, kept count,
        # observed margin) are reported below.
        res = flagship_fit(X, compact_iterations=None,
                           screen_iterations=50, screen_margin=2.0)
        jax.block_until_ready(res['weights'])
        return res

    run_screened()  # compile
    t0 = time.perf_counter()
    screened = run_screened()
    screened_elapsed = time.perf_counter() - t0

    mean_iters = float(np.mean(result["n_iters"]))
    baseline_seconds = (baseline["gram_seconds"]
                        + N_INIT * mean_iters
                        * baseline["per_iter_seconds"])
    # MEASURED end-to-end denominator (benchmarks/measure_config3_e2e.py):
    # full NumPy runs to tolerance, scaled linearly over the independent
    # restart axis.  When present it is the headline's primary
    # vs_baseline (no reconstruction); the reconstructed number stays in
    # extras.
    e2e = baseline.get("measured_end_to_end")
    baseline_seconds_measured = (e2e["protocol_seconds_100_restarts"]
                                 if e2e else None)
    # Interval on the reconstruction (protocol v4: the post-burn-in
    # per-iteration [q10, q90] SPREAD — not a CI, the samples trend)
    # and a conservative bound (fastest observed baseline iteration).
    spread = baseline.get("per_iter_seconds_spread")
    baseline_seconds_lo = baseline_seconds_hi = baseline_conservative = None
    if spread is not None:
        baseline_seconds_lo = (baseline["gram_seconds"] + N_INIT * mean_iters
                               * spread[0])
        baseline_seconds_hi = (baseline["gram_seconds"] + N_INIT * mean_iters
                               * spread[1])
        baseline_conservative = (baseline["gram_seconds"]
                                 + N_INIT * mean_iters
                                 * baseline["per_iter_seconds_min"])

    # Structural FLOP accounting (benchmarks/flops.py): total restart
    # iterations actually executed on device.  Lockstep vmapped loops
    # run every restart for the max trip count, so charge mean iters
    # (work the algorithm needed), not max (work the lockstep wasted).
    total_iters = float(np.sum(result["n_iters"]))
    fit_flops = (gram_flops(N_SAMPLES, N_FEATURES)
                 + total_iters * aa_outer_iteration_flops(
                     N_SAMPLES, N_FEATURES, K,
                     dict_iters=DICT_MAX_ITERATIONS))
    gflops_per_s = fit_flops / elapsed / 1e9
    gram_flops_per_s, gram_seconds = measure_gram_throughput(X)
    gram_tf32_flops_per_s, _ = measure_gram_throughput(
        X, precision='tensorfloat32')
    peak = peak_flops(dev.device_kind, HEADLINE_MATMUL_PRECISION)
    peak_f32 = peak_flops(dev.device_kind, 'float32')
    peak_tf32 = peak_flops(dev.device_kind, 'tensorfloat32')

    out = {
        "metric": "hadisst_protocol_aa_best100_time_to_tol",
        "value": round(elapsed, 4),
        "unit": "s",
        "vs_baseline": round(
            (baseline_seconds_measured if baseline_seconds_measured
             else baseline_seconds) / elapsed, 2),
        "extra": {
            "vs_baseline_measured": (
                round(baseline_seconds_measured / elapsed, 2)
                if baseline_seconds_measured else None),
            "baseline_seconds_measured_e2e": (
                round(baseline_seconds_measured, 1)
                if baseline_seconds_measured else None),
            "baseline_measured_seed_rel_spread": (
                round(e2e["seed_mean_rel_spread"], 3) if e2e else None),
            "baseline_measured_sem_rel": (
                round(e2e["per_restart_mean_sem_rel"], 4)
                if e2e and "per_restart_mean_sem_rel" in e2e else None),
            "baseline_measured_n_restarts": (
                len(e2e["restarts"]) if e2e else None),
            "baseline_measured_mean_outer_iters": (
                round(e2e["mean_outer_iters"], 1) if e2e else None),
            "vs_baseline_reconstructed": round(
                baseline_seconds / elapsed, 2),
            "cost": result["cost"],
            "cost_f64_audit": round(audit_cost_f64(result, X_host), 4),
            "matmul_precision": HEADLINE_MATMUL_PRECISION,
            "n_iter_best": result["n_iter"],
            "mean_outer_iters": round(mean_iters, 1),
            "compile_plus_first_run_s": round(compile_and_run, 2),
            "baseline_seconds_reconstructed": round(baseline_seconds, 2),
            "baseline_per_iter_s": round(baseline["per_iter_seconds"], 3),
            "baseline_per_iter_s_spread": (
                [round(s, 3) for s in spread]
                if spread is not None else None),
            "vs_baseline_spread": (
                [round(baseline_seconds_lo / elapsed, 2),
                 round(baseline_seconds_hi / elapsed, 2)]
                if baseline_seconds_lo is not None else None),
            "vs_baseline_conservative": (
                round(baseline_conservative / elapsed, 2)
                if baseline_conservative is not None else None),
            "alternating_update_gflops_per_s": round(gflops_per_s, 1),
            "restart_iterations_per_second": round(total_iters / elapsed, 1),
            "screened_seconds": round(screened_elapsed, 4),
            "screened_cost": screened["cost"],
            "screened_cost_f64_audit": round(
                audit_cost_f64(screened, X_host), 4),
            "screened_vs_baseline": round(
                ((baseline_seconds_measured if baseline_seconds_measured
                  else baseline_seconds)) / screened_elapsed, 2),
            "screened_diag": screened.get("screen"),
            # None values flag an invalid two-point-slope measurement
            # (noise produced a non-positive slope).
            "gram_matmul_gflops_per_s": (
                round(gram_flops_per_s / 1e9, 1)
                if gram_flops_per_s else None),
            "gram_matmul_seconds": (round(gram_seconds, 5)
                                    if gram_seconds else None),
            "gram_tf32_gflops_per_s": (
                round(gram_tf32_flops_per_s / 1e9, 1)
                if gram_tf32_flops_per_s else None),
            "share_of_peak": round(fit_flops / elapsed / peak, 4),
            "gram_f32_share_of_f32_peak": (
                round(gram_flops_per_s / peak_f32, 4)
                if gram_flops_per_s else None),
            "gram_tf32_share_of_tf32_peak": (
                round(gram_tf32_flops_per_s / peak_tf32, 4)
                if gram_tf32_flops_per_s else None),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices()), "card": card},
            "baseline_host": "numpy float64 on the previous 1-core host",
            "weights_backend": WEIGHTS_BACKEND,
            "workload": {**(baseline.get("workload") or {}),
                         "weights_max_iterations": WEIGHTS_MAX_ITERATIONS,
                         "compact_iterations": COMPACT_ITERS,
                         "restart_chunk": RESTART_CHUNK},
        },
    }
    return out


def main():
    print(json.dumps(headline()))


if __name__ == "__main__":
    main()
