#!/usr/bin/env python
"""A/B of the weights-QP backends on one GPU: fused kernel vs XLA.

Run from the repository root: ``python benchmarks/qp_kernel_ab.py``.

(a) the isolated grouped solve at the headline chunk (R=25, n=1788,
    k=6) under inner-iteration caps 25 and 1000;
(b) the flagship best-of-100 fit end to end (chip_smoke.py's flagship
    phase, bench.py's workload).

Runs alternate xla, pallas, pallas, xla in one process, so both
backends see the same card state; medians of the warm runs are
reported beside the card's name and power limit.  One JSON line per
measurement.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402

ROUNDS = 3   # each round runs xla, pallas, pallas, xla


def timed(fn, *args):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def alternate(fns, *args):
    """Warm each ``fns[name]`` once, then time ``ROUNDS`` rounds of
    xla, pallas, pallas, xla; returns the per-backend wall times."""
    for fn in fns.values():
        timed(fn, *args)
    times = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name in ("xla", "pallas", "pallas", "xla"):
            times[name].append(timed(fns[name], *args))
    return times


def main():
    from convex_dim_red_tpu.solvers.spg import quad_simplex_spg_batch_grouped
    from convex_dim_red_tpu.utils.cache import enable_compilation_cache

    _, card = chip_smoke.device_phase()
    enable_compilation_cache()

    A, B, X0 = (jnp.asarray(v, jnp.float32)
                for v in chip_smoke.qp_problem(25, 1788, 6, seed=0))
    for cap in (25, 1000):
        fns = {b: jax.jit(lambda A, B, X0, b=b: quad_simplex_spg_batch_grouped(
            A, B, X0, backend=b, max_iterations=cap))
            for b in ("xla", "pallas")}
        times = alternate(fns, A, B, X0)
        print(json.dumps({"ab": "isolated_qp", "R": 25, "n": 1788, "k": 6,
                          "cap": cap, "card": card, "times_s": times,
                          **{b + "_median_s": float(np.median(t))
                             for b, t in times.items()}}), flush=True)

    X = jax.device_put(bench.make_data(np.float32))
    fns = {b: (lambda X, b=b: bench.flagship_fit(X, b)['weights'])
           for b in ("xla", "pallas")}
    times = alternate(fns, X)
    iters = {b: float(np.mean(bench.flagship_fit(X, b)['n_iters']))
             for b in fns}
    print(json.dumps({"ab": "flagship_e2e", "card": card, "times_s": times,
                      "mean_outer_iters": iters,
                      **{b + "_median_s": float(np.median(t))
                         for b, t in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
