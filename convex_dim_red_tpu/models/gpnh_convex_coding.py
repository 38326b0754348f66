"""GPNH-regularized convex coding on the JAX core.

Re-implements the reference's GPNH convex coding
(reference: src/convex_dim_red/gpnh_convex_coding.py):
``min 0.5||X - Z W'||^2_F / n + lambda_W * Phi(W)`` over row-stochastic
weights ``Z`` and a free dictionary ``W``, where ``Phi`` penalizes
pairwise dictionary-column distances (gpnh_convex_coding.py:179-196).
Alternating steps:

- dictionary: the exact k x k linear solve
  ``(Z'Z/n + lambda_W G_W) W' = Z'X/n`` (reference :213-226 uses
  ``np.linalg.lstsq``; we use the same least-squares solve via SVD so a
  rank-deficient ``Z'Z`` cannot increase the cost).
- weights: per-row simplex QPs ``min 1/2 z'(W'W)z - (XW)[t]'z`` solved in
  lockstep as batched matmuls (reference :229-279 via guvectorize
  threads).

The whole fit is one jitted ``lax.while_loop`` (see
``archetypal_analysis`` module docstring for the shared design: on-device
convergence tests, float64 scalar cost reductions, host-side
monotonicity watchdog).
"""

import functools
import numbers
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.furthest_sum import furthest_sum, dissimilarities_from_kernel
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..solvers.spg import quad_simplex_spg_batch, resolve_qp_backend
from ..utils.precision import apply_matmul_precision, matmul_precision_scope
from ..utils.validation import check_array_shape, check_unit_axis_sums
from ..utils.vma import pvary_like
from ._common import (QPSolverConfig, make_config, STOPPING_CRITERIA,
                      has_converged, prepare_estimator_mesh)
from .archetypal_analysis import (_as_key, _scalar_dtype,
                                  _VERBOSE_CHUNK)

__all__ = [
    "GPNHConvexCoding",
    "gpnh_cost",
    "gpnh_regularization",
    "gpnh_regularization_masked",
    "update_gpnh_dictionary",
    "update_gpnh_weights",
    "iterate_gpnh_convex_coding",
]

INITIALIZATION_METHODS = (None, 'random', 'furthest_sum', 'custom')


def gpnh_regularization(dictionary):
    """GPNH penalty ``Phi(W) = 2/(k d (k-1)) sum_{i<j} ||w_i - w_j||^2``.

    Parity with reference ``_gpnh_regularization``
    (gpnh_convex_coding.py:179-196), vectorized via the identity
    ``sum_{i<j}||w_i - w_j||^2 = k sum_i ||w_i||^2 - ||sum_i w_i||^2``.
    """
    W = jnp.asarray(dictionary)
    n_features, n_components = W.shape
    if n_components == 1:
        return jnp.asarray(0.0, dtype=W.dtype)
    prefactor = 2.0 / (n_components * n_features * (n_components - 1.0))
    total = (n_components * jnp.sum(W * W)
             - jnp.sum(jnp.sum(W, axis=1) ** 2))
    return prefactor * total


def _gpnh_gram(n_features, n_components, dtype):
    """``G_W`` such that ``Phi(W) = 0.5 tr(W G_W W')`` (reference
    gpnh_convex_coding.py:296-300)."""
    if n_components > 1:
        prefactor = 4.0 / (n_features * n_components * (n_components - 1))
        return prefactor * (n_components * jnp.eye(n_components, dtype=dtype)
                            - jnp.ones((n_components, n_components),
                                       dtype=dtype))
    return jnp.zeros((n_components, n_components), dtype=dtype)


def gpnh_regularization_masked(dictionary, component_mask):
    """GPNH penalty over the ACTIVE dictionary columns only.

    Padded-``k`` analog of :func:`gpnh_regularization`: the penalty is
    evaluated with the *active* component count ``k_act = sum(mask)``
    in the prefactor and the sums restricted to active columns, so a
    padded fit optimizes exactly the ``k_act``-component objective
    (reference penalty definition gpnh_convex_coding.py:179-196 applied
    to the active sub-dictionary).  ``component_mask`` is a runtime
    ``(k_pad,)`` bool — the point of padding is one compiled program
    per component-count bucket.
    """
    W = jnp.asarray(dictionary)
    n_features = W.shape[0]
    m = component_mask.astype(W.dtype)
    k_act = jnp.sum(m)
    Wm = W * m[None, :]
    total = k_act * jnp.sum(Wm * Wm) - jnp.sum(jnp.sum(Wm, axis=1) ** 2)
    denom = k_act * n_features * jnp.maximum(k_act - 1.0, 1.0)
    pre = jnp.where(k_act > 1, 2.0 / denom, 0.0).astype(W.dtype)
    return pre * total


def _gpnh_gram_masked(n_features, component_mask, dtype):
    """Masked ``G_W``: the active-block GPNH Gram with the active-``k``
    prefactor, zero on padded rows/columns.  With the weights' padded
    columns pinned to zero, the dictionary normal equations become
    block-diagonal and the least-squares solve reproduces the unpadded
    active-block solution (padded columns fall in the null space and
    are zeroed explicitly by the caller)."""
    m = component_mask.astype(dtype)
    k_act = jnp.sum(m)
    k_pad = component_mask.shape[0]
    denom = n_features * k_act * jnp.maximum(k_act - 1.0, 1.0)
    pre = jnp.where(k_act > 1, 4.0 / denom, 0.0).astype(dtype)
    G = pre * (k_act * jnp.eye(k_pad, dtype=dtype)
               - jnp.ones((k_pad, k_pad), dtype=dtype))
    return G * m[:, None] * m[None, :]


def gpnh_cost(data, weights, dictionary, lambda_W=0):
    """Full GPNH objective.  Parity with reference ``_gpnh_cost``
    (gpnh_convex_coding.py:199-210)."""
    X = jnp.asarray(data)
    Z = jnp.asarray(weights)
    W = jnp.asarray(dictionary)
    n_samples = X.shape[0]
    resid = X - Z @ W.T
    cost = 0.5 * jnp.sum(resid * resid) / n_samples
    if lambda_W != 0:
        cost = cost + lambda_W * gpnh_regularization(W)
    return cost


def _cost_from_parts(trace_XtX, WtXtZ_tr, ZtZ, WtW, penalty, n_samples):
    """Trace-form objective from small k x k intermediates in scalar
    precision (reference gpnh_convex_coding.py:302-310)."""
    sdt = _scalar_dtype(ZtZ.dtype)
    tr_zw = jnp.sum(ZtZ.astype(sdt) * WtW.astype(sdt).T)
    return (0.5 * (trace_XtX.astype(sdt) - 2.0 * WtXtZ_tr.astype(sdt)
                   + tr_zw) / n_samples + penalty.astype(sdt))


def update_gpnh_dictionary(X, weights, ZtZ, GW, lambda_W=0):
    """Exact dictionary solve ``(Z'Z/n + lambda_W G_W) W' = Z'X/n``.

    Parity with reference ``_update_gpnh_dictionary``
    (gpnh_convex_coding.py:213-226); least-squares (SVD) solve for
    rank-deficiency safety.
    """
    X = jnp.asarray(X)
    Z = jnp.asarray(weights)
    n_samples = X.shape[0]
    ZtX = Z.T @ X
    lhs = ZtZ / n_samples + lambda_W * GW
    rhs = ZtX / n_samples
    sol = jnp.linalg.lstsq(lhs, rhs)[0]
    return sol.T


def update_gpnh_weights(X, weights, dictionary, component_mask=None,
                        **solver_kwargs):
    """Batched simplex-QP weights update.

    Parity with reference ``_update_gpnh_weights``
    (gpnh_convex_coding.py:254-279): per row solve
    ``min 1/2 z'(W'W)z - (XW)[t]'z`` on the simplex.

    ``component_mask`` (optional (k,) bool, runtime value) restricts
    every row to the masked sub-simplex — padded components stay
    exactly zero (padded-``k`` program bucketing; see
    ``solvers.spg.quad_simplex_spg``).
    """
    cfg = make_config(QPSolverConfig, solver_kwargs)
    X = jnp.asarray(X)
    W = jnp.asarray(dictionary)
    WtW = W.T @ W
    XW = X @ W
    return quad_simplex_spg_batch(WtW, -XW, jnp.asarray(weights),
                                  backend=cfg.backend,
                                  mask=component_mask, **cfg.kwargs())


@apply_matmul_precision
@functools.partial(
    jax.jit,
    static_argnames=('do_dict', 'do_weights', 'criterion', 'max_iterations',
                     'require_monotonic', 'weights_cfg'))
def _gpnh_core(X, Z, W, lambda_W, tolerance, component_mask=None, *,
               do_dict, do_weights, criterion, max_iterations,
               require_monotonic, weights_cfg):
    """Whole alternating GPNH fit as one on-device while loop.

    ``component_mask`` (optional (k,) bool, runtime value) runs a
    padded-``k`` fit equal to the ``sum(mask)``-component model: the
    weights QP pins padded columns of ``Z`` to exact zero, the penalty
    and its Gram use the active-``k`` prefactor over active columns
    (:func:`gpnh_regularization_masked`), and the dictionary solve's
    padded columns (null-space directions of the block-diagonal normal
    equations) are zeroed explicitly.  ``Z``/``W``'s padded columns
    must be zero on entry.  One compiled program then serves a bucket
    of component counts (see ``parallel.sweep.gpnh_model_selection_
    sweep``); the reference protocol this buckets is the per-k
    best-of-n_init sweep (reference bin/run_hadisst_gpnh.py:149-171).
    """
    n_samples, n_features = X.shape
    n_components = W.shape[1]
    sdt = _scalar_dtype(X.dtype)

    if component_mask is None:
        GW = _gpnh_gram(n_features, n_components, X.dtype)
    else:
        GW = _gpnh_gram_masked(n_features, component_mask, X.dtype)
    trace_XtX = jnp.sum(X.astype(sdt) * X.astype(sdt))

    def penalty(W):
        if component_mask is None:
            if_nonzero = gpnh_regularization(W).astype(sdt)
        else:
            if_nonzero = gpnh_regularization_masked(
                W, component_mask).astype(sdt)
        return jnp.where(lambda_W != 0, lambda_W * if_nonzero, 0.0)

    ZtZ = Z.T @ Z
    WtW = W.T @ W
    WtXtZ_tr = jnp.sum((X @ W).astype(sdt) * Z.astype(sdt))

    new_cost = _cost_from_parts(trace_XtX, WtXtZ_tr, ZtZ, WtW,
                                penalty(W), n_samples)
    tolerance = jnp.asarray(tolerance, dtype=sdt)

    # At least length 1: a zero-size trace cannot be traced through
    # the loop body's .at[n_iter].set (max_iterations=0 is legal and
    # must return the initial cost).
    cost_trace = jnp.zeros((max(int(max_iterations), 1),), dtype=sdt)
    inc_flags = jnp.zeros((2,), dtype=bool)

    # Watchdog threshold floored at the dtype's cost-evaluation
    # resolution.  Same 64*eps multiplier as the AA core (see the note
    # in archetypal_analysis._kernel_aa_core; not yet measured on the
    # H100).
    watchdog_floor = 64.0 * float(jnp.finfo(X.dtype).eps) * trace_XtX
    watchdog_thresh = jnp.maximum(tolerance, watchdog_floor)

    def increased(old, new):
        return (new > old) & (new - old > watchdog_thresh)

    def cond(carry):
        Z, W, ZtZ, old_cost, new_cost, n_iter, stop, trace, inc = carry
        return (~stop) & (n_iter < max_iterations)

    def body(carry):
        Z, W, ZtZ, old_cost, new_cost, n_iter, stop, trace, inc = carry
        old_cost = new_cost

        if do_dict:
            W = update_gpnh_dictionary(X, Z, ZtZ, GW, lambda_W=lambda_W)
            if component_mask is not None:
                # Padded columns are null-space directions of the
                # block-diagonal normal equations (Z's padded columns
                # are exactly zero); pin them to exact zero so no SVD
                # rounding leaks into the masked penalty or WtW.
                W = W * component_mask.astype(W.dtype)[None, :]
            WtW = W.T @ W
            WtXtZ_tr = jnp.sum((X @ W).astype(sdt) * Z.astype(sdt))
            new_cost = _cost_from_parts(trace_XtX, WtXtZ_tr, ZtZ, WtW,
                                        penalty(W), n_samples)
            inc = inc.at[0].set(inc[0] | increased(old_cost, new_cost))

        if do_weights:
            # backend excluded from kwargs(); re-thread it or the
            # Pallas routing silently degrades to XLA.  'auto' resolves
            # with fit-regime semantics (warm-started QPs; see
            # solvers.spg.resolve_qp_backend).
            Z = update_gpnh_weights(X, Z, W,
                                    component_mask=component_mask,
                                    backend=resolve_qp_backend(
                                        weights_cfg.backend,
                                        regime='fit'),
                                    **weights_cfg.kwargs())
            ZtZ = Z.T @ Z
            WtW = W.T @ W
            WtXtZ_tr = jnp.sum((X @ W).astype(sdt) * Z.astype(sdt))
            new_cost = _cost_from_parts(trace_XtX, WtXtZ_tr, ZtZ, WtW,
                                        penalty(W), n_samples)
            inc = inc.at[1].set(inc[1] | increased(old_cost, new_cost))

        trace = trace.at[n_iter].set(new_cost - old_cost)

        stop = has_converged(old_cost, new_cost, tolerance, criterion)
        if require_monotonic:
            stop = stop | jnp.any(inc)

        return Z, W, ZtZ, old_cost, new_cost, n_iter + 1, stop, trace, inc

    init = (Z, W, ZtZ, new_cost, new_cost, jnp.asarray(0, jnp.int32),
            jnp.asarray(False), cost_trace, inc_flags)
    # vma promotion for shard_map(check_vma=True) restart-sharded
    # callers; no-op outside shard_map (see _kernel_aa_core).
    init = pvary_like(init, Z, W)
    Z, W, ZtZ, old_cost, new_cost, n_iter, stop, cost_trace, inc_flags = (
        jax.lax.while_loop(cond, body, init))

    # ``stop`` lets the chunked verbose driver (iterate_gpnh_convex_
    # coding) distinguish convergence from the chunk iteration cap.
    return Z, W, new_cost, n_iter, cost_trace, inc_flags, stop


_STAGE_NAMES = ('dictionary', 'weights')


def iterate_gpnh_convex_coding(X, weights, dictionary, lambda_W=0,
                               update_weights=True, update_dictionary=True,
                               tolerance=1e-6, max_iterations=1000,
                               verbose=0, **kwargs):
    """Alternating GPNH fit on device.

    Mirrors reference ``_iterate_gpnh_convex_coding``
    (gpnh_convex_coding.py:282-402); returns
    ``(weights, dictionary, cost, n_iter, avg_time_per_iter,
    cost_deltas)``.
    """
    criterion = kwargs.get('stopping_criterion', 'abs_delta_f')
    if criterion not in STOPPING_CRITERIA:
        raise ValueError("unsupported stopping criterion '%s'" % criterion)
    require_monotonic = bool(kwargs.get('require_monotonic_cost_decrease',
                                        True))
    weights_cfg = make_config(QPSolverConfig,
                              kwargs.get('weights_solver_kwargs'))
    # Reference accepts dictionary_solver_kwargs but the exact solve has
    # no tunables; accepted and ignored for API parity.

    X = jnp.asarray(X)
    Z = jnp.asarray(weights)
    W = jnp.asarray(dictionary)

    core = functools.partial(
        _gpnh_core,
        do_dict=bool(update_dictionary), do_weights=bool(update_weights),
        criterion=criterion, require_monotonic=require_monotonic,
        weights_cfg=weights_cfg)
    lam_op = jnp.asarray(lambda_W, dtype=X.dtype)

    start = time.perf_counter()
    if verbose:
        # Reference-format table (gpnh_convex_coding.py:334-337, :392)
        # without host callbacks: chunked, state-resuming device
        # executions with the time column amortized per chunk — same
        # scheme as models.archetypal_analysis.iterate_kernel_aa.
        print("*** GPNH convex coding: n_components = {:d} ***".format(
            Z.shape[1]))
        print('{:<12s} | {:<13s} | {:<13s} | {:<12s}'.format(
            'Iteration', 'Cost', 'Cost delta', 'Time'))
        print(100 * '-')
        row = '{:12d} | {: 12.6e} | {: 12.6e} | {: 12.6e}'

        chunk = int(min(_VERBOSE_CHUNK, max_iterations))
        n_iter = 0
        stop = False
        deltas_parts = []
        inc_any = np.zeros(2, dtype=bool)
        cost = None
        while not stop and n_iter < int(max_iterations):
            this_chunk = min(chunk, int(max_iterations) - n_iter)
            t0 = time.perf_counter()
            Z, W, cost, n_it, trace, inc_flags, stop = core(
                X, Z, W, lam_op, tolerance, max_iterations=this_chunk)
            cost = jax.block_until_ready(cost)
            dt = time.perf_counter() - t0
            n_it = int(n_it)
            if n_it == 0:
                break
            deltas = np.asarray(trace)[:n_it]
            suffix = np.cumsum(deltas[::-1])[::-1]
            costs = float(cost) - suffix + deltas
            for i in range(n_it):
                print(row.format(n_iter + i + 1, costs[i], deltas[i],
                                 dt / n_it))
            deltas_parts.append(deltas)
            inc_any |= np.asarray(inc_flags)
            n_iter += n_it
            stop = bool(stop)
        if cost is None:
            # max_iterations == 0 skips the chunk loop entirely; match
            # the quiet path (which returns the initial cost) with a
            # zero-iteration core call so downstream float(cost) works.
            cost = jax.block_until_ready(core(
                X, Z, W, lam_op, tolerance, max_iterations=0)[2])
        inc_flags = inc_any
        cost_deltas = (np.concatenate(deltas_parts) if deltas_parts
                       else np.zeros((0,)))
        if stop and not inc_flags.any():
            print('*** Converged at iteration {:d} ***'.format(n_iter))
    else:
        Z, W, cost, n_iter, cost_trace, inc_flags, _ = core(
            X, Z, W, lam_op, tolerance,
            max_iterations=int(max_iterations))
        cost = jax.block_until_ready(cost)
        n_iter = int(n_iter)
        inc_flags = np.asarray(inc_flags)
        cost_deltas = np.asarray(cost_trace)[:n_iter]
    elapsed = time.perf_counter() - start

    if require_monotonic and inc_flags.any():
        stage = _STAGE_NAMES[int(np.argmax(inc_flags))]
        raise RuntimeError(
            'factorization cost increased after {} update'.format(stage))

    return Z, W, cost, n_iter, elapsed / max(n_iter, 1), cost_deltas


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def initialize_gpnh_dictionary(data, n_components, init='random', key=None,
                               **kwargs):
    """Random scaled-Gaussian dictionary or FurthestSum data columns
    (reference gpnh_convex_coding.py:41-81)."""
    data = jnp.asarray(data)
    n_samples, n_features = data.shape
    if init is None:
        init = 'random'

    if init == 'random':
        avg = jnp.sqrt(jnp.mean(jnp.abs(data)) / n_components)
        return avg * jax.random.normal(
            key, (n_features, n_components), dtype=data.dtype)

    if init == 'furthest_sum':
        start_index = kwargs.get('start_index')
        n_extra_steps = kwargs.get('n_extra_steps', 10)
        exclude = kwargs.get('exclude')
        if start_index is None:
            start_index = int(jax.random.randint(key, (), 0, n_samples))
        with matmul_precision_scope():
            kernel = data @ data.T
            diss = np.asarray(dissimilarities_from_kernel(kernel))
        selected = furthest_sum(diss, n_components, start_index,
                                exclude, n_extra_steps)
        return jnp.asarray(np.asarray(data)[np.asarray(selected)].T)

    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def initialize_gpnh_weights(data, n_components, init='random', key=None):
    if init in (None, 'random', 'furthest_sum'):
        data = jnp.asarray(data)
        return right_stochastic_matrix(
            key, (data.shape[0], n_components), dtype=data.dtype)
    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def _check_init_weights(weights, shape, whom):
    check_array_shape(np.asarray(weights), shape, whom)
    check_unit_axis_sums(np.asarray(weights), whom, axis=1)


def _check_init_dictionary(dictionary, shape, whom):
    check_array_shape(np.asarray(dictionary), shape, whom)


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


class GPNHConvexCoding:
    """Convex coding with GPNH dictionary regularization.

    API parity with the reference ``GPNHConvexCoding``
    (gpnh_convex_coding.py:405-668): constructor parameters, ``fit`` /
    ``fit_transform`` / ``transform`` / ``inverse_transform``, and fitted
    attributes ``weights``, ``dictionary``, ``cost``, ``n_iter``,
    ``avg_time_per_iter``, ``cost_deltas``.

    Extension: ``mesh=`` runs the fit as an explicit SPMD program
    over the mesh's ``samples`` axis
    (``parallel.sharded_aa.sharded_gpnh_fit``): data rows and per-row
    weight QPs stay device-local, the k-sized lstsq dictionary solve
    runs on psum'd ``Z'Z``/``Z'X``.  Partial-update sub-fits
    (``transform``) stay single-device.
    """

    def __init__(self, n_components, lambda_W=0, init=None,
                 tolerance=1e-6, max_iterations=1000,
                 verbose=0, random_state=None, mesh=None, **kwargs):
        self.n_components = n_components
        self.lambda_W = lambda_W
        self.init = init
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        self.verbose = verbose
        self.mesh = mesh
        self._key = _as_key(random_state)
        self.require_monotonic_cost_decrease = kwargs.get(
            'require_monotonic_cost_decrease', True)
        self.stopping_criterion = kwargs.get('stopping_criterion',
                                             'abs_delta_f')

        self.weights = None
        self.dictionary = None
        self.cost = 0
        self.n_iter = 0
        self.avg_time_per_iter = 0
        self.cost_deltas = None

        self.weights_solver_kwargs = kwargs.get('weights_solver_kwargs', {})
        self.dictionary_solver_kwargs = kwargs.get(
            'dictionary_solver_kwargs', {})

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _validate_params(self):
        if not isinstance(self.n_components, (numbers.Integral, np.integer)) \
                or self.n_components <= 0:
            raise ValueError(
                'Number of components must be a positive integer;'
                ' got (n_components=%r)' % self.n_components)
        if not isinstance(self.max_iterations,
                          (numbers.Integral, np.integer)) \
                or self.max_iterations <= 0:
            raise ValueError(
                'Maximum number of iterations must be a positive integer;'
                ' got (max_iterations=%r)' % self.max_iterations)
        if not isinstance(self.tolerance, numbers.Number) \
                or self.tolerance < 0:
            raise ValueError(
                'Tolerance for stopping criteria must be positive;'
                ' got (tolerance=%r)' % self.tolerance)

    def _gpnh_convex_coding(self, data, dictionary=None, weights=None,
                            update_dictionary=True, update_weights=True,
                            **kwargs):
        data = jnp.asarray(data)
        n_samples, n_features = data.shape

        if self.n_components is None:
            self.n_components = n_features
        self._validate_params()
        k = self.n_components
        whom = '_gpnh_convex_coding'

        if self.init == 'custom':
            _check_init_weights(weights, (n_samples, k), whom)
            _check_init_dictionary(dictionary, (n_features, k), whom)
        elif not update_dictionary and update_weights:
            _check_init_dictionary(dictionary, (n_features, k), whom)
            weights = initialize_gpnh_weights(
                data, k, init=self.init, key=self._next_key())
        elif update_dictionary and not update_weights:
            _check_init_weights(weights, (n_samples, k), whom)
            dictionary = initialize_gpnh_dictionary(
                data, k, init=self.init, key=self._next_key(), **kwargs)
        else:
            dictionary = initialize_gpnh_dictionary(
                data, k, init=self.init, key=self._next_key(), **kwargs)
            weights = initialize_gpnh_weights(
                data, k, init=self.init, key=self._next_key())

        if self.mesh is not None and update_dictionary and update_weights:
            return self._gpnh_sharded(data, jnp.asarray(weights),
                                      jnp.asarray(dictionary))

        (self.weights, self.dictionary, cost, n_iter, avg_time,
         cost_deltas) = iterate_gpnh_convex_coding(
            data, jnp.asarray(weights), jnp.asarray(dictionary),
            lambda_W=self.lambda_W,
            update_dictionary=update_dictionary,
            update_weights=update_weights,
            tolerance=self.tolerance,
            max_iterations=self.max_iterations,
            verbose=self.verbose,
            require_monotonic_cost_decrease=(
                self.require_monotonic_cost_decrease),
            stopping_criterion=self.stopping_criterion,
            weights_solver_kwargs=self.weights_solver_kwargs,
            dictionary_solver_kwargs=self.dictionary_solver_kwargs)

        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)

        return cost, n_iter, avg_time, cost_deltas

    def _gpnh_sharded(self, data, weights, dictionary):
        """SPMD fit over the estimator's mesh (single restart, every
        device on the sample axis)."""
        # Deferred import: parallel imports this module's helpers.
        from ..parallel.sharded_aa import sharded_gpnh_fit

        mesh = prepare_estimator_mesh(self.mesh, data.shape[0],
                                      'GPNHConvexCoding(mesh=...)')
        start = time.perf_counter()
        res = sharded_gpnh_fit(
            mesh, data, weights[None], dictionary[None],
            lambda_W=self.lambda_W, tolerance=self.tolerance,
            max_iterations=int(self.max_iterations),
            stopping_criterion=self.stopping_criterion,
            weights_solver_kwargs=self.weights_solver_kwargs)
        cost = jax.block_until_ready(res['cost'])
        elapsed = time.perf_counter() - start

        self.weights = res['weights']
        self.dictionary = res['dictionary']
        n_iter = int(res['n_iter'])
        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)
        cost_deltas = np.asarray(res['cost_deltas'])[:n_iter]
        return cost, n_iter, elapsed / max(n_iter, 1), cost_deltas

    def fit_transform(self, data, dictionary=None, weights=None, **kwargs):
        """Fit to ``data`` (n_samples, n_features); return the weights."""
        cost, n_iter, avg_time, cost_deltas = self._gpnh_convex_coding(
            data, dictionary=dictionary, weights=weights, **kwargs)
        self.cost = float(cost)
        self.n_iter = n_iter
        self.avg_time_per_iter = avg_time
        self.cost_deltas = cost_deltas
        return self.weights

    def fit(self, data, **kwargs):
        self.fit_transform(data, **kwargs)
        return self

    def transform(self, data):
        """Solve weights for new data with the fitted dictionary.

        Returns ``(weights, cost)`` (reference
        gpnh_convex_coding.py:623-652).
        """
        cost, _, _, _ = self._gpnh_convex_coding(
            data, dictionary=self.dictionary,
            update_dictionary=False, update_weights=True)
        return self.weights, float(cost)

    def inverse_transform(self, weights):
        """Map weights back to data space: ``Z @ W'``."""
        return jnp.asarray(weights) @ jnp.asarray(self.dictionary).T
