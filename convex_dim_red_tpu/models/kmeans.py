"""K-means clustering and gap-statistic model selection on the JAX core.

The reference delegates clustering to sklearn ``KMeans`` and
parallelizes gap-statistic reference draws with joblib process forks
(reference: src/convex_dim_red/kmeans.py).  Here Lloyd iterations are a
jitted ``lax.while_loop`` whose distance computation is one
``X @ C'`` matmul and whose centroid update is a one-hot
matmul (segment sum); k-means++ seeding is a ``fori_loop`` of
categorical draws; the ``n_init`` restarts are a ``vmap`` batch; and the
gap statistic's reference draws run as a ``lax.map`` over per-trial PRNG
keys — the joblib fork parallelism (kmeans.py:97-100) becomes on-device
batching.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.precision import apply_matmul_precision
from ..utils.vma import pvary_like

__all__ = ["KMeans", "kmeans_fit", "kmeans_plusplus", "random_init",
           "gap_statistic"]


@apply_matmul_precision
def _sq_dists(X, centroids):
    """Squared Euclidean distances (n, k) via one matmul."""
    x2 = jnp.sum(X * X, axis=1, keepdims=True)
    c2 = jnp.sum(centroids * centroids, axis=1)
    cross = X @ centroids.T
    return jnp.maximum(x2 - 2.0 * cross + c2[None, :], 0.0)


def kmeans_plusplus(X, n_clusters, key):
    """k-means++ seeding (Arthur & Vassilvitskii) with categorical draws."""
    X = jnp.asarray(X)
    n_samples = X.shape[0]
    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n_samples)
    centroids = jnp.zeros((n_clusters, X.shape[1]), dtype=X.dtype)
    centroids = centroids.at[0].set(X[first])

    def body(i, carry):
        centroids, key, d2 = carry
        # Update closest-distance vector with the most recent centroid.
        d_new = jnp.sum((X - centroids[i - 1][None, :]) ** 2, axis=1)
        d2 = jnp.minimum(d2, d_new)
        key, sub = jax.random.split(key)
        # Sample proportional to d2 (log-space categorical).
        logits = jnp.log(jnp.maximum(d2, jnp.finfo(X.dtype).tiny))
        idx = jax.random.categorical(sub, logits)
        centroids = centroids.at[i].set(X[idx])
        return centroids, key, d2

    d2 = jnp.full((n_samples,), jnp.inf, dtype=X.dtype)
    # vma promotion for shard_map(check_vma=True) callers (the sharded
    # gap statistic maps this over trial-sharded draws): the fresh
    # closest-distance init must carry the data/key varying axes.
    # No-op outside shard_map (utils/vma.py).
    init = pvary_like((centroids, key, d2), X, key)
    centroids, key, d2 = jax.lax.fori_loop(1, n_clusters, body, init)
    return centroids


def _lloyd(X, centroids, max_iter, tol_abs):
    """Lloyd iterations until centroid shift^2 < tol_abs."""
    n, d = X.shape
    k = centroids.shape[0]

    def assign(centroids):
        d2 = _sq_dists(X, centroids)
        labels = jnp.argmin(d2, axis=1)
        inertia = jnp.sum(jnp.min(d2, axis=1))
        return labels, inertia

    def cond(carry):
        centroids, shift, n_iter = carry
        return (shift >= tol_abs) & (n_iter < max_iter)

    def body(carry):
        centroids, shift, n_iter = carry
        labels, _ = assign(centroids)
        onehot = jax.nn.one_hot(labels, k, dtype=X.dtype)
        counts = jnp.sum(onehot, axis=0)
        sums = onehot.T @ X
        safe = jnp.maximum(counts, 1.0)
        new_centroids = sums / safe[:, None]
        # Empty clusters keep their previous centroid.
        new_centroids = jnp.where((counts > 0)[:, None], new_centroids,
                                  centroids)
        shift = jnp.sum((new_centroids - centroids) ** 2)
        return new_centroids, shift, n_iter + 1

    init = (centroids, jnp.asarray(jnp.inf, X.dtype),
            jnp.asarray(0, jnp.int32))
    # vma promotion for shard_map(check_vma=True) callers; no-op
    # outside shard_map (see kmeans_plusplus above).
    init = pvary_like(init, centroids, X)
    centroids, shift, n_iter = jax.lax.while_loop(cond, body, init)
    labels, inertia = assign(centroids)
    return centroids, labels, inertia, n_iter


def random_init(X, n_clusters, key):
    """Random seeding: ``n_clusters`` distinct observations drawn
    uniformly (sklearn ``init='random'`` semantics, the option exposed
    by the reference drivers, run_hadisst_kmeans.py:48-49)."""
    X = jnp.asarray(X)
    idx = jax.random.choice(key, X.shape[0], (n_clusters,), replace=False)
    return X[idx]


@apply_matmul_precision
@functools.partial(jax.jit, static_argnames=('n_clusters', 'n_init',
                                             'max_iter', 'init'))
def kmeans_fit(X, key, *, n_clusters, n_init=10, max_iter=300, tol=1e-4,
               init='k-means++'):
    """Best-of-``n_init`` k-means fit; restarts run as a vmap batch.

    ``tol`` follows sklearn semantics: scaled by the mean per-feature
    variance of ``X``.  Returns ``(centroids, labels, inertia, n_iter)``
    of the lowest-inertia restart.
    """
    X = jnp.asarray(X)
    tol_abs = jnp.asarray(tol, X.dtype) * jnp.mean(jnp.var(X, axis=0))
    seed = kmeans_plusplus if init == 'k-means++' else random_init

    def single(key):
        centroids = seed(X, n_clusters, key)
        return _lloyd(X, centroids, max_iter, tol_abs)

    keys = jax.random.split(key, n_init)
    centroids, labels, inertias, n_iters = jax.vmap(single)(keys)
    best = jnp.argmin(inertias)
    return (centroids[best], labels[best], inertias[best], n_iters[best])


class KMeans:
    """sklearn-compatible k-means estimator on the JAX core.

    Drop-in surface for the drivers that used sklearn ``KMeans``
    (reference bin/run_hadisst_kmeans.py:128-131): ``fit`` /
    ``fit_predict`` / ``predict`` and fitted attributes
    ``cluster_centers_``, ``labels_``, ``inertia_``, ``n_iter_``.

    Extension: ``mesh=`` runs the fit as an explicit SPMD program
    (``parallel.sharded_models.sharded_kmeans_fit``) with sample rows
    sharded over the mesh's ``samples`` axis and the ``n_init``
    restarts sharded over its ``restarts`` axis (padded up to the axis
    size; padding is masked out of the best-restart selection).
    """

    def __init__(self, n_clusters, init='k-means++', n_init=10,
                 max_iter=300, tol=1e-4, random_state=None, mesh=None):
        if init not in ('k-means++', 'random'):
            raise ValueError("init must be 'k-means++' or 'random' "
                             "(reference run_hadisst_kmeans.py:48-49)")
        self.init = init
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.mesh = mesh

        self.cluster_centers_ = None
        self.labels_ = None
        self.inertia_ = None
        self.n_iter_ = None

    def _key(self):
        from .archetypal_analysis import _as_key
        return _as_key(self.random_state)

    def fit(self, X):
        X = jnp.asarray(X)
        if self.mesh is not None:
            return self._fit_sharded(X)
        centroids, labels, inertia, n_iter = kmeans_fit(
            X, self._key(), n_clusters=self.n_clusters,
            n_init=self.n_init, max_iter=self.max_iter, tol=self.tol,
            init=self.init)
        self.cluster_centers_ = centroids
        self.labels_ = np.asarray(labels)
        self.inertia_ = float(inertia)
        self.n_iter_ = int(n_iter)
        return self

    def _fit_sharded(self, X):
        """SPMD fit over the estimator's mesh: samples over the sample
        axis, the n_init restarts over the restart axis."""
        # Deferred import: parallel imports this module's helpers.
        from ._common import prepare_estimator_mesh
        from ..parallel.sharded_models import sharded_kmeans_fit

        mesh = prepare_estimator_mesh(self.mesh, X.shape[0],
                                      'KMeans(mesh=...)',
                                      single_fit=False)
        r_shards = mesh.shape['restarts']
        n_init_padded = -(-self.n_init // r_shards) * r_shards

        res = sharded_kmeans_fit(
            mesh, X, self._key(), n_clusters=self.n_clusters,
            n_init=n_init_padded, max_iter=self.max_iter, tol=self.tol,
            init=self.init, n_valid_restarts=self.n_init)
        self.cluster_centers_ = res['centroids']
        self.labels_ = np.asarray(res['labels'])
        self.inertia_ = float(res['inertia'])
        self.n_iter_ = int(res['n_iter'])
        return self

    def fit_predict(self, X):
        return self.fit(X).labels_

    def predict(self, X):
        if self.cluster_centers_ is None:
            raise RuntimeError("KMeans instance is not fitted yet; "
                               "call fit() first")
        d2 = _sq_dists(jnp.asarray(X), self.cluster_centers_)
        return np.asarray(jnp.argmin(d2, axis=1))

    def transform(self, X):
        """Distances to each cluster center (sklearn ``transform``
        surface, used by the reference drivers' validation cost,
        run_hadisst_kmeans.py:281-282)."""
        if self.cluster_centers_ is None:
            raise RuntimeError("KMeans instance is not fitted yet; "
                               "call fit() first")
        d2 = _sq_dists(jnp.asarray(X), self.cluster_centers_)
        return np.asarray(jnp.sqrt(d2))


# ---------------------------------------------------------------------------
# Gap statistic
# ---------------------------------------------------------------------------


@apply_matmul_precision
@functools.partial(jax.jit, static_argnames=('n_clusters', 'n_trials',
                                             'n_init', 'max_iter'))
def _uniform_reference_wks(X, key, *, n_clusters, n_trials, n_init=10,
                           max_iter=300):
    """Per-trial inertias of k-means on uniform-box reference draws
    (reference kmeans.py:18-34), trials mapped on device."""
    X = jnp.asarray(X)
    fmin = jnp.min(X, axis=0)
    fmax = jnp.max(X, axis=0)

    def one_trial(key):
        key, sub = jax.random.split(key)
        draw = fmin + (fmax - fmin) * jax.random.uniform(
            sub, X.shape, dtype=X.dtype)
        _, _, inertia, _ = _kmeans_fit_inline(
            draw, key, n_clusters, n_init, max_iter)
        return inertia

    keys = jax.random.split(key, n_trials)
    return jax.lax.map(one_trial, keys)


def _kmeans_fit_inline(X, key, n_clusters, n_init, max_iter, tol=1e-4):
    tol_abs = jnp.asarray(tol, X.dtype) * jnp.mean(jnp.var(X, axis=0))

    def single(key):
        centroids = kmeans_plusplus(X, n_clusters, key)
        return _lloyd(X, centroids, max_iter, tol_abs)

    keys = jax.random.split(key, n_init)
    centroids, labels, inertias, n_iters = jax.vmap(single)(keys)
    best = jnp.argmin(inertias)
    return centroids[best], labels[best], inertias[best], n_iters[best]


@apply_matmul_precision
@functools.partial(jax.jit, static_argnames=('n_clusters', 'n_trials',
                                             'n_svd', 'n_init', 'max_iter'))
def _pca_reference_wks(X, key, *, n_clusters, n_trials, n_svd,
                       n_init=10, max_iter=300):
    """PCA-subspace-rotated uniform reference draws
    (reference kmeans.py:37-64)."""
    X = jnp.asarray(X)
    # Right singular vectors of X (principal directions).
    _, _, Vh = jnp.linalg.svd(X, full_matrices=False)
    Vh = Vh[:n_svd]
    Xp = X @ Vh.T
    fmin = jnp.min(Xp, axis=0)
    fmax = jnp.max(Xp, axis=0)

    def one_trial(key):
        key, sub = jax.random.split(key)
        draw = fmin + (fmax - fmin) * jax.random.uniform(
            sub, Xp.shape, dtype=X.dtype)
        draw = draw @ Vh
        _, _, inertia, _ = _kmeans_fit_inline(
            draw, key, n_clusters, n_init, max_iter)
        return inertia

    keys = jax.random.split(key, n_trials)
    return jax.lax.map(one_trial, keys)


def gap_statistic(X, Wk, n_components, n_trials=100,
                  reference='uniform', n_jobs=None, random_state=None):
    """Gap statistic (Tibshirani et al.) for k-means model selection.

    Signature parity with the reference ``gap_statistic``
    (kmeans.py:81-108); ``n_jobs`` is accepted and ignored (trials run
    on device).  Returns ``(gap, sk)``.
    """
    from .archetypal_analysis import _as_key
    del n_jobs
    key = _as_key(random_state)
    X = jnp.asarray(X)

    if reference == 'uniform':
        wks = _uniform_reference_wks(
            X, key, n_clusters=int(n_components), n_trials=int(n_trials))
    elif reference == 'pca':
        n_svd = int(min(100, X.shape[0], X.shape[1]))
        wks = _pca_reference_wks(
            X, key, n_clusters=int(n_components), n_trials=int(n_trials),
            n_svd=n_svd)
    else:
        raise ValueError("unrecognized reference distribution '%s'"
                         % reference)

    ln_wks = jnp.log(wks)
    sk = float(jnp.std(ln_wks) * jnp.sqrt(1.0 + 1.0 / n_trials))
    gap = float(jnp.mean(ln_wks) - jnp.log(Wk))
    return gap, sk
