#!/usr/bin/env python
"""Distributed scaling tour: every model family over a device mesh.

The reference is a single-process CPU package (SURVEY.md §2.4); this
framework scales the same estimators over a ``jax.sharding.Mesh``.
This script walks the whole surface on planted data:

  1. estimator-level ``mesh=`` — ArchetypalAnalysis / KernelAA /
     GPNHConvexCoding (sample-sharded SPMD fits), KMeans (samples +
     restarts), PCA (feature-sharded Gram path), sharded transform;
  2. multi-restart keep-best over the mesh (``aa_fit_restarts``),
     with two-phase screened restarts;
  3. a resumable model-selection sweep with mesh-distributed
     gap-statistic trials.

Run on real chips (uses all attached devices):

    python examples/distributed_scaling.py

or on a virtual 8-device CPU mesh (no GPU needed):

    python examples/distributed_scaling.py --cpu8
"""

import os
import sys
import time

if "--cpu8" in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np
import jax

if "--cpu8" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from convex_dim_red_tpu import (ArchetypalAnalysis, GPNHConvexCoding,
                                KernelAA, KMeans, PCA)
from convex_dim_red_tpu.parallel import (aa_fit_restarts, create_mesh,
                                         kmeans_model_selection_sweep)


def planted(rng, n, k, d):
    basis = rng.uniform(size=(k, d))
    Z = rng.uniform(size=(n, k))
    Z /= Z.sum(axis=1, keepdims=True)
    idx = rng.choice(n, size=k, replace=False)
    for comp, i in enumerate(idx):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis


def main():
    devices = jax.devices()
    n_dev = len(devices)
    print(f"devices: {n_dev} x {devices[0].platform}")

    rng = np.random.RandomState(0)
    k = 4
    n = 64 * n_dev          # divisible by the sample axis
    d = 16 * n_dev          # divisible by the feature axis (PCA)
    X = planted(rng, n, k, d)

    # 1-D mesh: every device on the sample axis (estimator fits).
    mesh = create_mesh(shape=(n_dev,), axis_names=("samples",))

    t0 = time.perf_counter()
    aa = ArchetypalAnalysis(n_components=k, init='furthest_sum',
                            tolerance=1e-8, max_iterations=300,
                            random_state=0, mesh=mesh).fit(X)
    print(f"AA (mesh={n_dev} samples): cost={aa.cost:.3e} "
          f"n_iter={aa.n_iter} [{time.perf_counter() - t0:.1f}s]")

    weights, cost = aa.transform(X)   # sharded per-row QPs
    print(f"AA.transform (sharded): cost={cost:.3e}")

    ka = KernelAA(n_components=k, init='random', random_state=0,
                  tolerance=1e-8, max_iterations=300, mesh=mesh)
    ka.fit(X @ X.T)
    print(f"KernelAA (mesh): cost={ka.cost:.3e} n_iter={ka.n_iter}")

    gp = GPNHConvexCoding(n_components=k, lambda_W=1e-3, init='random',
                          random_state=0, tolerance=1e-8,
                          max_iterations=300, mesh=mesh).fit(X)
    print(f"GPNH (mesh): cost={gp.cost:.3e} n_iter={gp.n_iter}")

    # 2-D mesh: restarts x samples (KMeans shards its n_init too).
    r_axis = max(1, n_dev // 2)
    mesh2d = create_mesh(shape=(r_axis, n_dev // r_axis),
                         axis_names=("restarts", "samples"))
    km = KMeans(n_clusters=2, n_init=2 * r_axis, random_state=0,
                mesh=mesh2d).fit(X)
    print(f"KMeans (mesh {r_axis}x{n_dev // r_axis}): "
          f"inertia={km.inertia_:.3e}")

    pca = PCA(n_components=4, mesh=mesh)   # feature-sharded Gram path
    scores = pca.fit_transform(X)
    print(f"PCA (feature-sharded): explained[0]="
          f"{pca.explained_variance_[0]:.3e} scores={scores.shape}")

    # Multi-restart keep-best sharded over the restart axis, with
    # two-phase screening (screen -> prune -> resume).
    mesh_r = create_mesh(shape=(n_dev,), axis_names=("restarts",))
    t0 = time.perf_counter()
    best = aa_fit_restarts(X, k, jax.random.PRNGKey(0),
                           n_init=4 * n_dev, init='random',
                           tolerance=1e-8, max_iterations=300,
                           mesh=mesh_r, screen_iterations=20)
    print(f"aa_fit_restarts (screened, {4 * n_dev} restarts over "
          f"{n_dev} devices): best cost={best['cost']:.3e} "
          f"[{time.perf_counter() - t0:.1f}s]")

    # Resumable sweep with mesh-distributed gap trials (fresh temp dir
    # per run; stale checkpoints from another config are also rejected
    # by the stored fingerprint).
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="distributed_scaling_sweep_")
    sweep = kmeans_model_selection_sweep(
        X, ks=[2, 3], key=jax.random.PRNGKey(1), n_init=2 * r_axis,
        n_trials=2 * r_axis, mesh=mesh2d, checkpoint_dir=ckpt)
    for kk, entry in sweep.items():
        print(f"kmeans sweep k={kk}: gap={entry['gap']:.3f} "
              f"(checkpointed to {ckpt})")

    print("distributed scaling tour OK")


if __name__ == "__main__":
    main()
