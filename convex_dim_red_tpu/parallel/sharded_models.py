"""Mesh-sharded k-means and PCA: the remaining model families on SPMD.

Completes the distributed layer (parallel/sharded_aa.py covers the
AA/GPNH factorizations): with this module every estimator in the
framework scales over a device mesh.

- :func:`sharded_kmeans_fit` — Lloyd iterations with the data rows
  sharded over a ``samples`` mesh axis.  The per-shard assignment step
  is local (one matmul); the centroid update crosses shards with a
  single ``psum`` of the k-sized count/sum statistics; seeding fetches
  candidate rows from their owning shard by a masked ``psum``
  broadcast.  Restarts shard over a ``restarts`` axis with the same
  cross-mesh keep-best selection as the sharded AA/GPNH fits.
  (Single-device analog: models/kmeans.py:kmeans_fit, itself the
  on-device replacement for the reference's sklearn KMeans,
  reference src/convex_dim_red/kmeans.py:30-32.)
- :func:`sharded_pca` — the Gram-space PCA path
  (models/pca.py:pca_fit(use_gram=True)) with the FEATURE dimension
  sharded: each shard forms its feature block's partial Gram, one
  ``psum`` accumulates the replicated n x n Gram, the small ``eigh``
  runs replicated, and the EOF back-projection stays feature-local, so
  the (k, d) components come out feature-sharded.  This is the layout
  for climate grids (d = grid cells >> n = months), where the
  reference fits sklearn PCA in-core (notebooks/hadisst_pca.ipynb
  run_pca cell).

Every replicated scalar (centroid shift, trip counts) is computed from
psum'd quantities, so the ``lax.while_loop`` trip counts agree within a
sample group and in-loop collectives cannot deadlock; restart groups
never communicate inside the loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..models.kmeans import _sq_dists
from ..utils.precision import apply_matmul_precision
from ..utils.vma import pvary_like
from . import sharded_aa as _sharded_aa
from .sharded_aa import _select_best

__all__ = ["sharded_kmeans_fit", "sharded_pca", "sharded_gap_statistic"]


@apply_matmul_precision
def sharded_kmeans_fit(mesh, X, key, *, n_clusters, n_init=10,
                       max_iter=300, tol=1e-4, init='k-means++',
                       n_valid_restarts=None,
                       restart_axis="restarts", sample_axis="samples"):
    """Best-of-``n_init`` k-means over a (restarts x samples) mesh.

    ``X`` (n_samples, n_features) has rows sharded over
    ``sample_axis``; the ``n_init`` restarts shard over
    ``restart_axis`` (``n_init`` must divide by the axis size; pad and
    pass ``n_valid_restarts`` otherwise).  ``tol`` follows sklearn
    semantics (scaled by the mean per-feature variance of ``X``),
    matching the single-device ``kmeans_fit``.

    Returns a dict: best ``centroids`` (replicated), ``labels`` for the
    local rows (sharded over samples), ``inertia``, ``n_iter``, and the
    per-restart ``inertias``/``n_iters`` (sharded over restarts).
    """
    if init not in ('k-means++', 'random'):
        raise ValueError("init must be 'k-means++' or 'random'")
    if n_valid_restarts is None:
        n_valid_restarts = n_init
    keys = jax.random.split(key, n_init)
    k = int(n_clusters)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(sample_axis, None), P(restart_axis)),
        out_specs=(P(),                  # best centroids
                   P(sample_axis),       # labels of local rows
                   P(),                  # best inertia
                   P(),                  # best n_iter
                   P(restart_axis),      # all inertias
                   P(restart_axis)),     # all n_iters
        check_vma=_sharded_aa.CHECK_VMA)
    def fit(X_loc, keys_loc):
        n_loc, d = X_loc.shape
        shard = jax.lax.axis_index(sample_axis)
        n_global = n_loc * jax.lax.psum(1, sample_axis)

        # sklearn tol scaling from global per-feature variance.
        s1 = jax.lax.psum(jnp.sum(X_loc, axis=0), sample_axis)
        s2 = jax.lax.psum(jnp.sum(X_loc * X_loc, axis=0), sample_axis)
        var = s2 / n_global - (s1 / n_global) ** 2
        tol_abs = jnp.asarray(tol, X_loc.dtype) * jnp.mean(var)

        def fetch_row(global_idx):
            """Broadcast row ``global_idx`` of the sharded X: the
            owning shard contributes it, the rest contribute zeros."""
            local = global_idx - shard * n_loc
            owned = (local >= 0) & (local < n_loc)
            row = X_loc[jnp.clip(local, 0, n_loc - 1)]
            return jax.lax.psum(
                jnp.where(owned, row, jnp.zeros_like(row)), sample_axis)

        def seed(key):
            if init == 'random':
                # Same key on every shard -> identical global draw.
                idx = jax.random.choice(key, n_global, (k,),
                                        replace=False)
                return jax.vmap(fetch_row)(idx)

            # k-means++: the closest-distance vector stays local; the
            # categorical draw runs on its (n,)-sized all_gather.
            key, sub = jax.random.split(key)
            first = jax.random.randint(sub, (), 0, n_global)
            C = jnp.zeros((k, d), X_loc.dtype).at[0].set(fetch_row(first))

            def body(i, carry):
                C, key, d2_loc = carry
                d_new = jnp.sum((X_loc - C[i - 1][None, :]) ** 2, axis=1)
                d2_loc = jnp.minimum(d2_loc, d_new)
                d2_full = jax.lax.all_gather(d2_loc, sample_axis,
                                             tiled=True)
                key, sub = jax.random.split(key)
                logits = jnp.log(jnp.maximum(
                    d2_full, jnp.finfo(X_loc.dtype).tiny))
                idx = jax.random.categorical(sub, logits)
                return C.at[i].set(fetch_row(idx)), key, d2_loc

            d2 = jnp.full((n_loc,), jnp.inf, X_loc.dtype)
            # Promote ONLY the closest-distance carry: it mixes in the
            # sample-varying X_loc each step, while C and key must stay
            # typed sample-invariant (C is assembled from psum'd rows)
            # so the final best centroids can be claimed replicated.
            (d2,) = pvary_like((d2,), X_loc, key)
            C, key, d2 = jax.lax.fori_loop(1, k, body, (C, key, d2))
            return C

        def assign(C):
            d2 = _sq_dists(X_loc, C)
            labels = jnp.argmin(d2, axis=1)
            inertia = jax.lax.psum(jnp.sum(jnp.min(d2, axis=1)),
                                   sample_axis)
            return labels, inertia

        def lloyd(C0):
            def cond(carry):
                C, shift, it = carry
                return (shift >= tol_abs) & (it < max_iter)

            def body(carry):
                C, shift, it = carry
                labels, _ = assign(C)
                onehot = jax.nn.one_hot(labels, k, dtype=X_loc.dtype)
                counts = jax.lax.psum(jnp.sum(onehot, axis=0),
                                      sample_axis)
                sums = jax.lax.psum(onehot.T @ X_loc, sample_axis)
                new_C = sums / jnp.maximum(counts, 1.0)[:, None]
                new_C = jnp.where((counts > 0)[:, None], new_C, C)
                shift = jnp.sum((new_C - C) ** 2)
                return new_C, shift, it + 1

            # Restart-varying trip counts: promote the scheduler
            # scalars to the centroid batch's (restart) axes.
            init = (C0,) + pvary_like(
                (jnp.asarray(jnp.inf, X_loc.dtype),
                 jnp.asarray(0, jnp.int32)), C0)
            C, shift, n_iter = jax.lax.while_loop(cond, body, init)
            _, inertia = assign(C)
            return C, inertia, n_iter

        # vmapped restarts run lockstep within this restart group (the
        # batched while_loop advances until every lane converges), same
        # as the single-device kmeans_fit restart batch.
        Cs0 = jax.vmap(seed)(keys_loc)
        Cs, inertias, n_iters = jax.vmap(lloyd)(Cs0)

        (C_best,), inertia, n_iter, _ = _select_best(
            (Cs,), inertias, jnp.zeros((inertias.shape[0], 1),
                                       inertias.dtype),
            n_iters, n_valid=n_valid_restarts, restart_axis=restart_axis)
        labels, _ = assign(C_best)
        return C_best, labels, inertia, n_iter, inertias, n_iters

    centroids, labels, inertia, n_iter, inertias, n_iters = fit(X, keys)
    return {
        'centroids': centroids,
        'labels': labels,
        'inertia': inertia,
        'n_iter': n_iter,
        'inertias': inertias,
        'n_iters': n_iters,
    }


@apply_matmul_precision
def sharded_pca(mesh, X, *, n_components, center=True,
                feature_axis="samples"):
    """Gram-path PCA with the feature dimension sharded over the mesh.

    Each shard centers its feature block and forms the partial Gram;
    one ``psum`` yields the replicated n x n Gram; the small
    ``eigh`` runs replicated; the (k, d) components come back sharded
    over ``feature_axis`` because the back-projection
    ``(Xc' U / s)`` only needs local columns.  Math identical to
    ``models.pca.pca_fit(use_gram=True)``.

    Returns a dict: ``components`` (k, d) feature-sharded, ``scores``
    (n, k), ``mean`` (d,) feature-sharded, ``explained_variance`` and
    ``singular_values`` (k,), all but components/mean replicated.
    """
    k = int(n_components)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=P(None, feature_axis),
        out_specs=(P(None, feature_axis),  # components
                   P(),                    # scores
                   P(feature_axis),        # mean
                   P(),                    # explained_variance
                   P()),                   # singular_values
        check_vma=_sharded_aa.CHECK_VMA)
    def fit(X_loc):
        n_samples = X_loc.shape[0]
        mean_loc = (jnp.mean(X_loc, axis=0) if center
                    else jnp.zeros((X_loc.shape[1],), X_loc.dtype))
        Xc = X_loc - mean_loc[None, :]
        G = jax.lax.psum(Xc @ Xc.T, feature_axis)
        evals, evecs = jnp.linalg.eigh(G)            # ascending
        evals = evals[::-1][:k]
        evecs = evecs[:, ::-1][:, :k]
        svals = jnp.sqrt(jnp.maximum(evals, 0.0))
        safe = jnp.maximum(svals, jnp.finfo(X_loc.dtype).tiny)
        components_loc = (Xc.T @ (evecs / safe[None, :])).T
        scores = evecs * svals[None, :]
        explained = (svals ** 2) / max(n_samples - 1, 1)
        return components_loc, scores, mean_loc, explained, svals

    components, scores, mean, explained, svals = fit(X)
    return {
        'components': components,
        'scores': scores,
        'mean': mean,
        'explained_variance': explained,
        'singular_values': svals,
    }


@apply_matmul_precision
def sharded_gap_statistic(mesh, X, Wk, n_components, *, n_trials=100,
                          reference='uniform', random_state=None,
                          trial_axis="restarts", n_init=10, max_iter=300):
    """Gap statistic with the reference-draw trials sharded over the
    mesh (SURVEY §2.4 P2: the reference forks joblib processes per
    trial, kmeans.py:97-100; on device the trials are embarrassingly
    parallel and only the final mean/std cross shards via ``psum``).

    Same per-trial PRNG keys as the single-device
    ``models.kmeans.gap_statistic``, so the returned ``(gap, sk)``
    matches it up to reduction order.  ``n_trials`` must divide the
    ``trial_axis`` size.
    """
    from ..models.archetypal_analysis import _as_key
    from ..models.kmeans import _kmeans_fit_inline

    if reference not in ('uniform', 'pca'):
        raise ValueError("unrecognized reference distribution '%s'"
                         % reference)
    X = jnp.asarray(X)
    keys = jax.random.split(_as_key(random_state), n_trials)
    k = int(n_components)
    n_svd = int(min(100, X.shape[0], X.shape[1]))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, None), P(trial_axis, None)),
        out_specs=(P(), P()),
        check_vma=_sharded_aa.CHECK_VMA)
    def stats(X_rep, keys_loc):
        if reference == 'uniform':
            fmin = jnp.min(X_rep, axis=0)
            fmax = jnp.max(X_rep, axis=0)

            def draw(sub):
                return fmin + (fmax - fmin) * jax.random.uniform(
                    sub, X_rep.shape, dtype=X_rep.dtype)
        else:
            _, _, Vh = jnp.linalg.svd(X_rep, full_matrices=False)
            Vh = Vh[:n_svd]
            Xp = X_rep @ Vh.T
            fmin = jnp.min(Xp, axis=0)
            fmax = jnp.max(Xp, axis=0)

            def draw(sub):
                u = fmin + (fmax - fmin) * jax.random.uniform(
                    sub, Xp.shape, dtype=X_rep.dtype)
                return u @ Vh

        def one_trial(key):
            key, sub = jax.random.split(key)
            _, _, inertia, _ = _kmeans_fit_inline(
                draw(sub), key, k, n_init, max_iter)
            return jnp.log(inertia)

        ln = jax.lax.map(one_trial, keys_loc)
        m1 = jax.lax.psum(jnp.sum(ln), trial_axis)
        m2 = jax.lax.psum(jnp.sum(ln * ln), trial_axis)
        mean = m1 / n_trials
        std = jnp.sqrt(jnp.maximum(m2 / n_trials - mean * mean, 0.0))
        return mean, std

    mean, std = stats(X, keys)
    sk = float(std) * float(np.sqrt(1.0 + 1.0 / n_trials))
    return float(mean) - float(np.log(Wk)), sk
