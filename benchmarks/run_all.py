#!/usr/bin/env python
"""Full benchmark suite: the five BASELINE.md configs.

Writes one JSON object per config to stdout (and benchmarks/results.json,
which git ignores) with wall-clock timings on the attached GPU, in one
process.  ``bench.py`` at the repo root holds the headline benchmark
(config 3), which this suite runs in the same process:

1. synthetic k=3 AA on ~200x50 Gaussian data (reference test workload)
2. HadISST-scale k-means + gap statistic
3. HadISST-scale AA best-of-100 (bench.py's headline)
4. JRA-55-scale PCA -> GPNH convex coding
5. (stretch) multi-restart AA sweep k=2..20 x 50 restarts
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from convex_dim_red_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax  # noqa: E402

from convex_dim_red_tpu import (KMeans, PCA,  # noqa: E402
                                gap_statistic, aa_fit_restarts,
                                gpnh_fit_restarts)
from convex_dim_red_tpu.parallel.sweep import (  # noqa: E402
    aa_model_selection_sweep)


def timed(fn):
    fn()  # warm-up / compile
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def config1_synthetic_aa():
    """Reference test workload: k=3 AA on 200x50 Gaussian data."""
    rng = np.random.RandomState(0)
    X = rng.standard_normal((200, 50)).astype(np.float32)

    def run():
        return aa_fit_restarts(X, 3, jax.random.PRNGKey(0), n_init=10,
                               init='furthest_sum', tolerance=1e-8,
                               max_iterations=500)
    result, seconds = timed(run)
    return {"config": "synthetic_k3_aa_200x50_best10",
            "seconds": round(seconds, 4), "cost": result['cost'],
            "n_iter": result['n_iter']}


def _hadisst_scale_data(dtype=np.float32, n=1788, d=16384):
    rng = np.random.RandomState(42)
    U = rng.standard_normal((n, 8))
    V = rng.standard_normal((8, d))
    X = U @ V + 0.3 * rng.standard_normal((n, d))
    X -= X.mean(axis=0)
    X /= X.std(axis=0) + 1e-12
    return X.astype(dtype)


def config2_kmeans():
    X = jax.device_put(_hadisst_scale_data())

    def run():
        model = KMeans(n_clusters=4, n_init=10, random_state=0).fit(X)
        gap, sk = gap_statistic(X, model.inertia_, 4, n_trials=20,
                                random_state=0)
        return model, gap, sk
    (model, gap, sk), seconds = timed(run)

    # Reference frozen experiment scale: gap N_TRIALS=100
    # (reference bin/run_hadisst_kmeans_wrapper.sh:40-44).  The NumPy
    # denominator is measured as a trial subset scaled over the
    # independent trial axis (benchmarks/measure_baselines.py
    # config2_ref).
    def run_ref():
        model = KMeans(n_clusters=4, n_init=10, random_state=0).fit(X)
        gap, sk = gap_statistic(X, model.inertia_, 4, n_trials=100,
                                random_state=0)
        return model, gap, sk
    (model_r, gap_r, sk_r), seconds_ref = timed(run_ref)
    return {"config": "hadisst_scale_kmeans_k4_gap20",
            "seconds": round(seconds, 4),
            "inertia": model.inertia_, "gap": gap, "gap_sk": sk,
            "ref_scale": {"n_trials": 100,
                          "seconds": round(seconds_ref, 4),
                          "inertia": model_r.inertia_,
                          "gap": gap_r, "gap_sk": sk_r}}


def config3_headline():
    import bench
    return bench.headline()


def config4_pca_gpnh():
    """JRA-55 protocol: PCA to 167 modes, then GPNH best-of-16."""
    X = jax.device_put(_hadisst_scale_data(n=732, d=8192))

    def run(n_init):
        pca = PCA(n_components=167)
        pcs = pca.fit_transform(X)
        result = gpnh_fit_restarts(
            np.asarray(pcs), 4, jax.random.PRNGKey(0), n_init=n_init,
            lambda_W=1e-3, tolerance=1e-5,
            stopping_criterion='rel_delta_f', max_iterations=300,
            weights_solver_kwargs={'max_iterations': 1000})
        return result
    result, seconds = timed(lambda: run(16))

    # Reference frozen experiment scale: N_INIT=100
    # (reference bin/run_jra55_pca_gpnh_wrapper.sh:40-44).  NumPy
    # denominator: restart subset scaled over the independent restart
    # axis (benchmarks/measure_baselines.py config4_ref).
    result_r, seconds_ref = timed(lambda: run(100))
    return {"config": "jra55_scale_pca167_gpnh_k4_best16",
            "seconds": round(seconds, 4), "cost": result['cost'],
            "n_iter": result['n_iter'],
            "ref_scale": {"n_init": 100,
                          "seconds": round(seconds_ref, 4),
                          "cost": result_r['cost'],
                          "n_iter": result_r['n_iter']}}


def config5_sweep():
    """Stretch: AA model-selection sweep k=2..20 x 50 restarts."""
    X = _hadisst_scale_data(n=900, d=4096)
    ks = list(range(2, 21, 3))  # 2,5,8,11,14,17,20

    t0 = time.perf_counter()
    results = aa_model_selection_sweep(
        X, ks, jax.random.PRNGKey(0), n_init=50, tolerance=1e-5,
        stopping_criterion='rel_delta_f', max_iterations=200,
        init='random', component_bucket=8)
    seconds = time.perf_counter() - t0
    return {"config": "aa_sweep_k2_20_x50_restarts",
            "seconds": round(seconds, 2),
            "costs": {k: round(v['cost'], 4) for k, v in results.items()},
            "per_k_seconds": {k: round(v['elapsed'], 2)
                              for k, v in results.items()}}


def _attach_measured_baselines(report):
    """Merge measured end-to-end NumPy baseline times (written by
    benchmarks/measure_baselines.py) as ``vs_baseline_measured``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baselines_measured.json")
    if not os.path.exists(path):
        return
    with open(path) as f:
        baselines = json.load(f)
    for name in ("config1", "config2", "config4"):
        entry = report.get(name)
        base = baselines.get(name)
        if not (isinstance(entry, dict) and base
                and "seconds" in entry):
            continue
        entry["baseline_seconds_measured"] = round(base["seconds"], 2)
        entry["vs_baseline_measured"] = round(
            base["seconds"] / entry["seconds"], 2)
        for key in ("cost", "inertia"):
            if key in base:
                entry["baseline_" + key] = base[key]
        # Reference frozen-scale comparison (the GPU measured at full
        # n_trials=100 / n_init=100; the NumPy side a labeled scaled
        # subset taken on the previous 1-core host — see
        # measure_baselines.config{2,4}_ref).
        ref_base = baselines.get(name + "_ref")
        ref_entry = entry.get("ref_scale")
        if ref_base and isinstance(ref_entry, dict) \
                and "seconds" in ref_entry:
            ref_entry["baseline_seconds_scaled"] = round(
                ref_base["seconds"], 2)
            ref_entry["baseline_method"] = ref_base["method"]
            ref_entry["vs_baseline_scaled"] = round(
                ref_base["seconds"] / ref_entry["seconds"], 2)


def main():
    configs = [("config1", config1_synthetic_aa),
               ("config2", config2_kmeans),
               ("config3", config3_headline),
               ("config4", config4_pca_gpnh),
               ("config5", config5_sweep)]
    selected = set(sys.argv[1:])
    if selected:
        unknown = selected - {name for name, _ in configs}
        if unknown:
            raise SystemExit(f"unknown configs: {sorted(unknown)}")
        configs = [(n, f) for n, f in configs if n in selected]

    # Merge into the existing report: re-running a subset must not drop
    # the other configs.
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "results.json")
    report = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            report = json.load(f)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("run_all.py needs a GPU; JAX reports platform %r"
                         % dev.platform)
    import bench
    report["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices()),
                        "card": bench.card_line()}

    import subprocess
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True,
                             cwd=os.path.dirname(out_path)).stdout.strip()
    except OSError:
        rev = None

    for name, fn in configs:
        try:
            fresh = fn()
        except Exception as exc:  # keep the suite running
            fresh = {"error": repr(exc)}
        if isinstance(fresh, dict) and "error" not in fresh:
            # Per-config provenance: configs measured at different
            # code states/devices are distinguishable in the merged
            # report ("device" at top level only reflects the last run).
            fresh["measured_at"] = {"git_rev": rev or "unknown",
                                    "device": report["device"]}
        report[name] = fresh
        print(json.dumps({name: report[name]}), flush=True)
    _attach_measured_baselines(report)

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
