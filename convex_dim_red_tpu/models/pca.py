"""PCA / EOF analysis on the JAX core.

The reference performs PCA with sklearn inside the analysis notebooks
(``run_pca`` in notebooks/hadisst_pca.ipynb: fit PCA on latitude-weighted
flattened anomalies, reassemble EOF patterns + principal components).
This module provides the equivalent estimator on JAX: economy SVD of the
centered data matrix (one XLA ``svd`` call), with a Gram-space path for
the very-wide matrices (n_features >> n_samples) typical of climate
grids.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.precision import apply_matmul_precision

__all__ = ["PCA", "pca_fit"]


@apply_matmul_precision
@functools.partial(jax.jit, static_argnames=('n_components', 'center',
                                             'use_gram'))
def pca_fit(X, *, n_components, center=True, use_gram=False):
    """Fit PCA; returns (components, explained_variance, mean, scores).

    ``use_gram=True`` computes the eigendecomposition of the n x n Gram
    matrix instead of the SVD of the n x d data — cheaper when
    ``n_features >> n_samples`` and maps to a single matmul plus a
    small eigh.
    """
    X = jnp.asarray(X)
    n_samples = X.shape[0]
    mean = jnp.mean(X, axis=0) if center else jnp.zeros(
        (X.shape[1],), X.dtype)
    Xc = X - mean[None, :]

    if use_gram:
        G = Xc @ Xc.T
        evals, evecs = jnp.linalg.eigh(G)  # ascending
        evals = evals[::-1][:n_components]
        evecs = evecs[:, ::-1][:, :n_components]
        svals = jnp.sqrt(jnp.maximum(evals, 0.0))
        safe = jnp.maximum(svals, jnp.finfo(X.dtype).tiny)
        components = (Xc.T @ (evecs / safe[None, :])).T
        scores = evecs * svals[None, :]
    else:
        U, S, Vh = jnp.linalg.svd(Xc, full_matrices=False)
        svals = S[:n_components]
        components = Vh[:n_components]
        scores = U[:, :n_components] * svals[None, :]

    explained_variance = (svals ** 2) / max(n_samples - 1, 1)
    return components, explained_variance, mean, scores


class PCA:
    """Principal component analysis with the sklearn-style surface the
    reference notebooks rely on: ``fit`` / ``transform`` /
    ``fit_transform`` / ``inverse_transform``, ``components_``,
    ``explained_variance_``, ``explained_variance_ratio_``, ``mean_``.

    Extension: ``mesh=`` runs the Gram-path fit as an explicit
    SPMD program (``parallel.sharded_models.sharded_pca``) with the
    FEATURE dimension sharded over the mesh's ``samples`` axis — the
    right split for the very-wide climate-grid matrices this class
    targets (n_features >> n_samples)."""

    def __init__(self, n_components, center=True, use_gram='auto',
                 tol=0.0, random_state=None, mesh=None):
        self.n_components = n_components
        self.center = center
        self.use_gram = use_gram
        self.mesh = mesh
        # Accepted for parity with the sklearn constructor the reference
        # notebook calls (``PCA(n_components, tol=1e-8, random_state=rng)``,
        # notebooks/hadisst_pca.ipynb run_pca cell); this implementation
        # computes the exact SVD/eigh, so neither affects the result.
        self.tol = tol
        self.random_state = random_state

        self.components_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None
        self.mean_ = None
        self.singular_values_ = None
        self.noise_variance_ = None

    def fit(self, X):
        self.fit_transform(X)
        return self

    def fit_transform(self, X):
        X = jnp.asarray(X)
        n_samples, n_features = X.shape
        if self.mesh is not None:
            components, explained, mean, scores = self._fit_sharded(X)
        else:
            use_gram = (n_features > 4 * n_samples
                        if self.use_gram == 'auto'
                        else bool(self.use_gram))
            components, explained, mean, scores = pca_fit(
                X, n_components=int(self.n_components),
                center=self.center, use_gram=use_gram)
        self.components_ = components
        self.explained_variance_ = np.asarray(explained)
        self.mean_ = mean
        self.singular_values_ = np.sqrt(
            self.explained_variance_ * max(n_samples - 1, 1))

        total_var = float(jnp.sum(jnp.var(X, axis=0, ddof=1)))
        self.explained_variance_ratio_ = (
            self.explained_variance_ / total_var if total_var > 0
            else self.explained_variance_ * 0.0)

        # sklearn semantics: mean variance of the discarded components
        # (the reference notebook writes it as the ``noise_variance``
        # netCDF attr, hadisst_pca.ipynb run_pca cell).
        rank_bound = min(n_samples, n_features)
        if self.n_components < rank_bound:
            self.noise_variance_ = float(
                (total_var - self.explained_variance_.sum())
                / (rank_bound - self.n_components))
        else:
            self.noise_variance_ = 0.0
        return scores

    def _fit_sharded(self, X):
        """SPMD Gram-path fit with the feature dimension sharded."""
        # Deferred import: parallel imports models (solver configs).
        from ._common import prepare_estimator_mesh
        from ..parallel.sharded_models import sharded_pca

        mesh = prepare_estimator_mesh(self.mesh, X.shape[1],
                                      'PCA(mesh=...)',
                                      dim_name='n_features')
        res = sharded_pca(mesh, X, n_components=int(self.n_components),
                          center=self.center)
        return (res['components'], res['explained_variance'],
                res['mean'], res['scores'])

    @apply_matmul_precision
    def transform(self, X):
        Xc = jnp.asarray(X) - self.mean_[None, :]
        return Xc @ self.components_.T

    @apply_matmul_precision
    def inverse_transform(self, scores):
        return jnp.asarray(scores) @ self.components_ + self.mean_[None, :]
