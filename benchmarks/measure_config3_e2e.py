#!/usr/bin/env python
"""Measure the flagship config-3 NumPy baseline END-TO-END.

Round-4 verdict item 1: the headline denominator was *reconstructed*
(capped 13-iteration runs -> trimmed per-iteration tail x mean device
iteration count), with a [q10, q90] spread spanning 2.8x.  This script
retires that asterisk by running the actual protocol to tolerance:
best-of-``N_INIT_MEASURED`` restarts per seed, ``SEEDS`` independent
seeds, every restart run to the reference stopping rule (rel_delta_f
1e-5, dictionary solver capped at 1 SPG step per outer iteration —
reference bin/run_hadisst_aa.py:165, wrapper n_init=100
bin/run_hadisst_aa_wrapper.sh:40-44).  Restarts are independent by
construction (the reference's keep-best loop, run_hadisst_aa.py:158-174,
creates a fresh model per restart), so the 100-restart protocol time is
the measured mean per-restart time x 100 — linear scaling over the
independent axis, labeled as such.  Each measured restart pays its own
Gram (as the reference does: archetypal_analysis.py:1032 recomputes the
kernel per fit).

Results merge into ``BASELINE_MEASURED.json`` under
``measured_end_to_end``; bench.py then reports the headline
``vs_baseline`` from this measured denominator (keeping the old
reconstruction as ``vs_baseline_reconstructed``).

Must run on an IDLE 1-core host (concurrent load inflates the baseline
and would overstate our speedup).  Budget ~80-90 min for the default
3 seeds x 4 restarts.

Usage: ``python benchmarks/measure_config3_e2e.py [n_seeds]
[start_seed]`` — with ``start_seed`` given, the new restarts MERGE
with the existing ``measured_end_to_end`` entry (additive evidence:
more independent restarts tighten the denominator's spread).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmarks.numpy_baseline import aa_fit_numpy  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BASELINE_MEASURED.json")

# Protocol constants — keep in lockstep with bench.py.
N_SAMPLES = 1788
N_FEATURES = 16384
K = 6
N_INIT_PROTOCOL = 100
N_INIT_MEASURED = 4
SEEDS = 3
TOL = 1e-5
MAX_ITER = 500
CRITERION = 'rel_delta_f'
DICT_MAX_ITERATIONS = 1


def make_data():
    rng = np.random.RandomState(42)
    U = rng.standard_normal((N_SAMPLES, 8))
    V = rng.standard_normal((8, N_FEATURES))
    X = U @ V + 0.3 * rng.standard_normal((N_SAMPLES, N_FEATURES))
    X -= X.mean(axis=0)
    X /= X.std(axis=0) + 1e-12
    return X


def main():
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else SEEDS
    start_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    try:
        load1 = os.getloadavg()[0]
    except OSError:
        load1 = None
    X = make_data()

    seed_summaries = []
    restarts = []
    if start_seed:
        # Merge mode: extend the existing measurement with more
        # independent seeds.
        with open(OUT) as f:
            prev = json.load(f).get("measured_end_to_end")
        if prev:
            restarts = list(prev["restarts"])
            seed_summaries = list(prev["seed_summaries"])
    for seed in range(start_seed, start_seed + n_seeds):
        rng = np.random.RandomState(seed)
        seed_t0 = time.perf_counter()
        best_cost = np.inf
        for r in range(N_INIT_MEASURED):
            t0 = time.perf_counter()
            _, _, cost, n_iter = aa_fit_numpy(
                X, K, rng, tolerance=TOL, max_iterations=MAX_ITER,
                dict_iterations=DICT_MAX_ITERATIONS,
                stopping_criterion=CRITERION, init='random')
            dt = time.perf_counter() - t0
            best_cost = min(best_cost, cost)
            restarts.append({"seed": seed, "restart": r,
                             "seconds": round(dt, 2),
                             "n_iter": int(n_iter),
                             "cost": float(cost)})
            print(json.dumps(restarts[-1]), flush=True)
        seed_summaries.append({
            "seed": seed,
            "seconds_best_of_%d" % N_INIT_MEASURED:
                round(time.perf_counter() - seed_t0, 2),
            "best_cost": float(best_cost)})

    secs = np.array([r["seconds"] for r in restarts], dtype=float)
    iters = np.array([r["n_iter"] for r in restarts], dtype=float)
    seeds_present = sorted({r["seed"] for r in restarts})
    seed_means = np.array(
        [np.mean([r["seconds"] for r in restarts if r["seed"] == s])
         for s in seeds_present])
    per_restart = float(np.mean(secs))
    # Seed-level relative RANGE (max-min over best-of-4 seed blocks):
    # dominated by the restart-iteration lottery at block size 4 and
    # does not shrink with more seeds.  The denominator's statistical
    # uncertainty is the standard error of the per-restart mean, which
    # DOES shrink as restarts accumulate — that is the run-to-run
    # spread bar for the headline ratio.
    rel_spread = float((seed_means.max() - seed_means.min())
                       / (2.0 * np.mean(seed_means)))
    sem_rel = float(np.std(secs, ddof=1) / np.sqrt(secs.size)
                    / per_restart)
    seed_sem_rel = float(np.std(seed_means, ddof=1)
                         / np.sqrt(seed_means.size)
                         / np.mean(seed_means))

    entry = {
        "method": (
            "full end-to-end numpy f64 runs to tolerance "
            "(rel_delta_f %g, dict cap %d, weights cap 1000): %d seeds x "
            "best-of-%d restarts, each restart paying its own Gram as "
            "the reference does; 100-restart protocol seconds = mean "
            "per-restart seconds x 100 (restarts are independent; "
            "linear scaling over the independent axis)"
            % (TOL, DICT_MAX_ITERATIONS, len(seeds_present),
               N_INIT_MEASURED)),
        "per_restart_seconds_mean": per_restart,
        "per_restart_seconds_std": float(np.std(secs, ddof=1)),
        "per_restart_seconds_all": [float(s) for s in secs],
        "per_seed_restart_means": [float(m) for m in seed_means],
        "seed_mean_rel_spread": rel_spread,
        "per_restart_mean_sem_rel": sem_rel,
        "seed_mean_sem_rel": seed_sem_rel,
        "mean_outer_iters": float(np.mean(iters)),
        "outer_iters_all": [int(i) for i in iters],
        "protocol_seconds_100_restarts": per_restart * N_INIT_PROTOCOL,
        "seed_summaries": seed_summaries,
        "loadavg_at_start": load1,
        "restarts": restarts,
    }

    with open(OUT) as f:
        doc = json.load(f)
    doc["measured_end_to_end"] = entry
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({"protocol_seconds_100_restarts":
                      entry["protocol_seconds_100_restarts"],
                      "per_restart_seconds_mean": per_restart,
                      "seed_mean_rel_spread": rel_spread}), flush=True)


if __name__ == "__main__":
    main()
