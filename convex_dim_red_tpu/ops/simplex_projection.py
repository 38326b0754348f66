"""Euclidean projection onto the probability simplex, in JAX.

The reference implements the classic sort-and-threshold algorithm as a
scalar Numba loop batched over rows/columns with ``guvectorize``
(reference: src/convex_dim_red/simplex_projection.py:13-47).  Here the
threshold search is expressed as a fully vectorized rank computation
(sort + cumulative sum + masked count), so a single call projects an
arbitrarily batched stack of vectors in one fused XLA computation — the
sort and the elementwise tail run on the VPU, and batching costs nothing
extra because every lane does identical work.

Algorithm (Held/Wolfe/Crowder; equivalently Duchi et al. 2008): with
``u = sort(x, descending)`` and ``s_j = u_1 + ... + u_j``, the active-set
size is ``rho = max{ j : u_j - (s_j - 1)/j > 0 }`` and the threshold is
``tau = (s_rho - 1)/rho``; the projection is ``max(x - tau, 0)``.  This
computes the same fixed point as the reference's backward scan.
"""

import jax.numpy as jnp

__all__ = [
    "simplex_project",
    "simplex_project_vector",
    "simplex_project_rows",
    "simplex_project_columns",
    "simplex_project_masked",
]


def simplex_project(x, axis=-1):
    """Project ``x`` onto the standard simplex along ``axis``.

    Every 1-D slice of ``x`` along ``axis`` is replaced by its Euclidean
    projection onto ``{p : p >= 0, sum(p) = 1}``.  Works for any batch
    shape; the computation is fully vectorized.
    """
    x = jnp.asarray(x)
    if x.ndim == 0:
        # Projection of a scalar onto the 1-point simplex is 1.
        return jnp.ones_like(x)

    n = x.shape[axis]
    u = jnp.flip(jnp.sort(x, axis=axis), axis=axis)  # descending
    css = jnp.cumsum(u, axis=axis)

    shape = [1] * x.ndim
    shape[axis] = n
    j = jnp.arange(1, n + 1, dtype=x.dtype).reshape(shape)

    # rho = number of indices with u_j - (s_j - 1)/j > 0  (always >= 1).
    positive = u - (css - 1.0) / j > 0
    rho = jnp.sum(positive, axis=axis, keepdims=True)

    css_rho = jnp.take_along_axis(css, rho - 1, axis=axis)
    tau = (css_rho - 1.0) / rho.astype(x.dtype)

    return jnp.maximum(x - tau, 0.0)


def simplex_project_masked(x, mask, axis=-1):
    """Project onto the sub-simplex with masked-out coordinates pinned
    to zero: ``{p : p >= 0, sum(p) = 1, p_i = 0 for ~mask_i}``.

    Exact reduction to :func:`simplex_project`: masked entries are
    replaced by the per-slice sentinel ``-(2*max|x_active| + 2)``, which
    is provably below the projection threshold ``tau`` of the active
    entries (``tau >= -max|x_active| - 1``) and never enters the
    active-set count, so the result on active coordinates equals the
    projection of the active subvector onto its own simplex.  This is
    the primitive that lets one compiled program serve a *bucket* of
    component counts: pad ``k`` to a bucket size and pass a runtime
    mask (see ``parallel.restarts.aa_fit_restarts(pad_components_to)``).
    """
    x = jnp.asarray(x)
    mask = jnp.asarray(mask, bool)
    scale = jnp.max(jnp.abs(jnp.where(mask, x, 0)), axis=axis,
                    keepdims=True)
    sentinel = (-(2.0 * scale + 2.0)).astype(x.dtype)
    return simplex_project(jnp.where(mask, x, sentinel), axis=axis)


def simplex_project_vector(x):
    """Project a single vector onto the standard simplex.

    Parity with reference ``simplex_project_vector``
    (src/convex_dim_red/simplex_projection.py:13-27).
    """
    return simplex_project(x, axis=-1)


def simplex_project_rows(a):
    """Project each row of ``a`` onto the standard simplex.

    Parity with reference ``simplex_project_rows``
    (src/convex_dim_red/simplex_projection.py:40-47), but one fused
    batched XLA op instead of a threaded scalar loop.
    """
    return simplex_project(a, axis=-1)


def simplex_project_columns(a):
    """Project each column of ``a`` onto the standard simplex.

    Parity with reference ``simplex_project_columns``
    (src/convex_dim_red/simplex_projection.py:30-37).
    """
    return simplex_project(a, axis=-2)
