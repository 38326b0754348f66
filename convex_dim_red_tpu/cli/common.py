"""Shared case-study driver machinery.

Every reference driver follows one template (reference
bin/run_hadisst_aa.py:177-447 and siblings): load netCDF → year/latitude
filters → latitude weighting → flatten → NaN-feature mask →
chronological train/validation split → (optional TimeSeriesSplit CV) →
best-of-``n_init`` fit → reconstruction metrics → netCDF output with a
metric-attribute block.  This module implements that template once, on
the JAX core: the keep-best restarts run as one vmapped on-device batch
(``parallel.restarts.aa_fit_restarts``) instead of the reference's
serial Python loop.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from ..models._common import QPSolverConfig, make_config
from ..models.archetypal_analysis import _as_key
from ..models.gpnh_convex_coding import GPNHConvexCoding
from ..models.kmeans import KMeans, gap_statistic
from ..parallel.restarts import aa_fit_restarts
from ..pipelines.dataset import Dataset, Variable, decode_cf_time, \
    open_dataset
from ..pipelines.preprocess import (latitude_weights,
                                    restore_missing_features)
from ..solvers.spg import quad_simplex_spg_batch

__all__ = [
    "add_common_args",
    "load_field",
    "aa_analysis",
    "gpnh_analysis",
    "kmeans_analysis",
    "rmse",
]


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def add_common_args(parser, model):
    """Add the flag set shared by the reference drivers."""
    parser.add_argument('input_file', help='input data file')
    parser.add_argument('output_file', help='name of output file')
    parser.add_argument('--n-components', dest='n_components', type=int,
                        default=1, help='number of components')
    if model == 'aa':
        parser.add_argument('--delta', dest='delta', type=float, default=0.0,
                            help='dictionary relaxation parameter')
        parser.add_argument('--init', dest='init',
                            choices=['random', 'furthest_sum'],
                            default='random', help='initialization method')
    elif model == 'gpnh':
        parser.add_argument('--lambda-W', dest='lambda_W', type=float,
                            default=0.0, help='dictionary regularization')
        parser.add_argument('--init', dest='init',
                            choices=['random', 'furthest_sum'],
                            default='random', help='initialization method')
    if model in ('aa', 'gpnh'):
        parser.add_argument('--n-init', dest='n_init', type=int, default=100,
                            help='number of initializations')
        parser.add_argument('--tolerance', dest='tolerance', type=float,
                            default=1e-6, help='stopping tolerance')
        parser.add_argument('--max-iterations', dest='max_iterations',
                            type=int, default=10000,
                            help='maximum number of iterations')
    else:  # kmeans
        parser.add_argument('--init', dest='init',
                            choices=['random', 'k-means++'],
                            default='k-means++',
                            help='initialization method')
        parser.add_argument('--n-init', dest='n_init', type=int, default=10,
                            help='number of initializations')
        parser.add_argument('--tolerance', dest='tolerance', type=float,
                            default=1e-4, help='stopping tolerance')
        parser.add_argument('--max-iterations', dest='max_iterations',
                            type=int, default=10000,
                            help='maximum number of iterations')
        parser.add_argument('--n-trials', dest='n_trials', type=int,
                            default=100, help='gap statistic trials')
        parser.add_argument('--n-jobs', dest='n_jobs', type=int, default=1,
                            help='number of jobs to use (accepted for '
                                 'parity; trials run on device)')
        parser.add_argument('--reference', dest='reference',
                            choices=['uniform', 'pca'], default='uniform',
                            help='gap statistic reference distribution')
    parser.add_argument('--random-seed', dest='random_seed', type=int,
                        default=None, help='random seed')
    parser.add_argument('--verbose', dest='verbose', action='store_true',
                        help='produce verbose output')
    parser.add_argument('--platform', dest='platform', default=None,
                        choices=['cpu', 'gpu'],
                        help='force a JAX platform (default: JAX picks '
                             'the GPU when there is one)')
    return parser


def apply_platform(args):
    if getattr(args, 'platform', None):
        jax.config.update('jax_platforms', args.platform)
    if getattr(args, 'platform', None) != 'cpu':
        # Persistent-cache CPU executables are machine-feature-specific
        # (the AOT loader warns of SIGILL on a mismatch), so an explicit
        # CPU run skips the cache.
        from ..utils.cache import enable_compilation_cache
        enable_compilation_cache()


def validate_common_args(args):
    if args.n_components < 1:
        raise ValueError('Number of components must be at least 1')
    if getattr(args, 'delta', 0) < 0:
        raise ValueError('Relaxation parameter must be non-negative')
    if getattr(args, 'tolerance', 1) < 0:
        raise ValueError('Stopping tolerance must be positive')
    if args.n_init < 1:
        raise ValueError('Number of initializations must be at least 1')
    if args.max_iterations < 1:
        raise ValueError('Maximum number of iterations must be at least 1')


def load_field(input_file, var_name, time_name, lat_name=None,
               start_year=None, end_year=None, min_latitude=None,
               max_latitude=None, lat_weights='none',
               restrict_to_base_period=False):
    """Load + filter a field and return the driver's working arrays.

    Returns a dict with ``data`` (n_t, *grid), ``years``, ``months``,
    ``weights`` (broadcastable to the grid), feature dim metadata, and
    the source dataset (for coordinate passthrough).
    """
    ds = open_dataset(input_file)

    if start_year is not None:
        ds = ds.sel_time_years(time_name, start_year, end_year)
    if min_latitude is not None and lat_name is not None:
        ds = ds.sel_range(lat_name, min_latitude, max_latitude)

    if restrict_to_base_period:
        # Gridded anomaly products carry base_period_* attrs; EOF/PC
        # products carry eofs_* (the climatology period the EOFs were
        # computed over — reference bin/run_jra55_pca_aa.py:247-258).
        b0 = ds.attrs.get('base_period_start_year',
                          ds.attrs.get('eofs_start_year'))
        b1 = ds.attrs.get('base_period_end_year',
                          ds.attrs.get('eofs_end_year'))
        if b0 is None or b1 is None:
            raise ValueError(
                'restrict_to_base_period needs base_period_*_year or '
                'eofs_*_year attrs on %s' % input_file)
        ds = ds.sel_time_years(time_name, int(b0), int(b1))

    var = ds[var_name]
    years, months = decode_cf_time(ds.coords[time_name]) \
        if time_name in ds.coords else (None, None)

    weights = None
    if lat_name is not None and lat_name in ds.coords:
        w = latitude_weights(ds.coords[lat_name].data, lat_weights)
        # Broadcast the 1-D latitude weights over the variable's grid.
        shape = [1] * (len(var.dims) - 1)
        lat_axis = var.dims.index(lat_name) - 1  # after dropping time
        shape[lat_axis] = w.size
        weights = w.reshape(shape)

    feature_dims = [d for d in var.dims if d != time_name]
    feature_shape = [var.data.shape[var.dims.index(d)]
                     for d in feature_dims]

    return {
        'dataset': ds,
        'data': var.data,
        'years': years,
        'months': months,
        'weights': weights,
        'feature_dims': feature_dims,
        'feature_shape': feature_shape,
        'time_values': ds.coords[time_name].data
        if time_name in ds.coords else None,
        'time_name': time_name,
    }


def _aa_transform(archetypes, data, key, weights_cfg, max_iterations):
    """Weights for new data against fitted archetypes
    (reference archetypal_analysis.py:1151-1199)."""
    archetypes = jnp.asarray(archetypes)
    data = jnp.asarray(data)
    n_samples = data.shape[0]
    k = archetypes.shape[0]

    A = archetypes @ archetypes.T
    B = -(data @ archetypes.T)
    m = jax.random.uniform(key, (n_samples, k), dtype=data.dtype)
    Z0 = m / jnp.sum(m, axis=1, keepdims=True)

    cfg = weights_cfg.kwargs()
    # kwargs() excludes backend; re-thread it or the configured (or
    # 'auto'-resolved oneshot Pallas) routing silently degrades to the
    # XLA default — same pattern as ArchetypalAnalysis.transform.
    cfg['backend'] = weights_cfg.backend
    cfg['max_iterations'] = int(max_iterations)
    Z = quad_simplex_spg_batch(A, B, Z0, **cfg)
    resid = data - Z @ archetypes
    cost = 0.5 * float(jnp.sum(resid * resid)) / n_samples
    return Z, cost


def aa_analysis(training_data, validation_data, *, n_components, delta,
                init, n_init, tolerance, max_iterations, random_seed,
                cross_validate=False, n_folds=10,
                dictionary_solver_kwargs=None, weights_solver_kwargs=None,
                stopping_criterion='abs_delta_f', verbose=False):
    """Best-of-``n_init`` AA fit + metrics (the template of reference
    bin/run_hadisst_aa.py:run_aa, with on-device vmapped restarts)."""
    key = _as_key(random_seed)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)

    attrs = {}

    if cross_validate:
        from sklearn.model_selection import TimeSeriesSplit
        tscv = TimeSeriesSplit(n_splits=n_folds)
        cv_test_costs, cv_test_rmses = [], []
        for train, test in tscv.split(training_data):
            key, k_fit, k_tr = jax.random.split(key, 3)
            fold = aa_fit_restarts(
                training_data[train], n_components, k_fit, n_init,
                delta=delta, init=init, tolerance=tolerance,
                max_iterations=max_iterations,
                stopping_criterion=stopping_criterion,
                dictionary_solver_kwargs=dictionary_solver_kwargs,
                weights_solver_kwargs=weights_solver_kwargs)
            Zt, ct = _aa_transform(fold['archetypes'],
                                   training_data[test], k_tr, weights_cfg,
                                   max_iterations)
            cv_test_costs.append(ct)
            cv_test_rmses.append(
                rmse(training_data[test], Zt @ fold['archetypes']))
        # DELIBERATE reference quirk: the held-out-fold (test) statistics
        # are recorded under the 'training_set_*' attr names, exactly as
        # the reference writes them (run_hadisst_aa.py:299-302; its
        # per-fold TRAIN stats at :232 are computed but never written, so
        # they are omitted here entirely).  Downstream notebooks read
        # these names; renaming would break attr-schema parity.
        attrs.update({
            'training_set_cost': '{:16.8e}'.format(np.mean(cv_test_costs)),
            'training_set_cost_std': '{:16.8e}'.format(np.std(cv_test_costs)),
            'training_set_rmse': '{:16.8e}'.format(np.mean(cv_test_rmses)),
            'training_set_rmse_std': '{:16.8e}'.format(np.std(cv_test_rmses)),
            'n_folds': '{:d}'.format(n_folds),
        })

    key, k_fit, k_val = jax.random.split(key, 3)
    start = time.perf_counter()
    best = aa_fit_restarts(
        training_data, n_components, k_fit, n_init, delta=delta,
        init=init, tolerance=tolerance, max_iterations=max_iterations,
        stopping_criterion=stopping_criterion,
        dictionary_solver_kwargs=dictionary_solver_kwargs,
        weights_solver_kwargs=weights_solver_kwargs)
    elapsed = time.perf_counter() - start

    recon = np.asarray(best['weights'] @ best['archetypes'])
    training_cost = best['cost']
    training_rmse = rmse(training_data, recon)

    validation_cost = np.nan
    validation_rmse = np.nan
    if validation_data is not None and len(validation_data):
        Zv, validation_cost = _aa_transform(
            best['archetypes'], validation_data, k_val, weights_cfg,
            max_iterations)
        validation_rmse = rmse(validation_data,
                               Zv @ best['archetypes'])

    if not cross_validate:
        attrs.update({
            'training_set_cost': '{:16.8e}'.format(training_cost),
            'training_set_rmse': '{:16.8e}'.format(training_rmse),
        })
    attrs.update({
        'training_set_size': '{:d}'.format(training_data.shape[0]),
        'test_set_cost': '{:16.8e}'.format(validation_cost),
        'test_set_rmse': '{:16.8e}'.format(validation_rmse),
        'test_set_size': '{:d}'.format(
            0 if validation_data is None else validation_data.shape[0]),
        'n_iter': '{:d}'.format(best['n_iter']),
        'avg_time_per_iter': '{:16.8e}'.format(
            elapsed / max(best['n_iter'], 1)),
        'elapsed_time': '{:16.8e}'.format(elapsed),
        'init': init,
        'n_init': '{:d}'.format(n_init),
        'delta': '{:16.8e}'.format(delta),
        'max_iterations': '{:d}'.format(max_iterations),
        'tolerance': '{:16.8e}'.format(tolerance),
    })

    return best, attrs


def gpnh_analysis(training_data, validation_data, *, n_components, lambda_W,
                  init, n_init, tolerance, max_iterations, random_seed,
                  cross_validate=False, n_folds=10,
                  weights_solver_kwargs=None,
                  stopping_criterion='abs_delta_f', verbose=False):
    """Best-of-``n_init`` GPNH fit + metrics (template of reference
    bin/run_hadisst_gpnh.py).  With the drivers' default random init the
    restarts run as one vmapped on-device batch
    (``parallel.restarts.gpnh_fit_restarts``); other inits fall back to
    a host loop with a warm jit cache."""
    from ..parallel.restarts import gpnh_fit_restarts

    key = _as_key(random_seed)

    def fit_once(data, key):
        model = GPNHConvexCoding(
            n_components=n_components, lambda_W=lambda_W, init=init,
            tolerance=tolerance, max_iterations=max_iterations,
            random_state=key, stopping_criterion=stopping_criterion,
            require_monotonic_cost_decrease=False,
            weights_solver_kwargs=weights_solver_kwargs or {})
        model.fit_transform(data)
        return model

    def fit_best(data, key):
        if init in (None, 'random', 'furthest_sum'):
            # Both driver inits run as one vmapped on-device batch
            # (furthest_sum starts are vmapped over per-restart keys;
            # parallel/restarts._gpnh_fit_batch).
            result = gpnh_fit_restarts(
                data, n_components, key, n_init, lambda_W=lambda_W,
                init=init or 'random', tolerance=tolerance,
                max_iterations=max_iterations,
                stopping_criterion=stopping_criterion,
                weights_solver_kwargs=weights_solver_kwargs)
            model = GPNHConvexCoding(
                n_components=n_components, lambda_W=lambda_W,
                init=init or 'random', tolerance=tolerance,
                max_iterations=max_iterations, random_state=key,
                stopping_criterion=stopping_criterion,
                require_monotonic_cost_decrease=False,
                weights_solver_kwargs=weights_solver_kwargs or {})
            model.weights = result['weights']
            model.dictionary = result['dictionary']
            model.cost = result['cost']
            model.n_iter = result['n_iter']
            model.cost_deltas = result['cost_deltas']
            model.avg_time_per_iter = 0.0
            return model
        best = None  # custom init: host keep-best over estimator fits
        for _ in range(n_init):
            key, sub = jax.random.split(key)
            model = fit_once(data, sub)
            if best is None or model.cost < best.cost:
                best = model
        return best

    attrs = {}
    if cross_validate:
        from sklearn.model_selection import TimeSeriesSplit
        tscv = TimeSeriesSplit(n_splits=n_folds)
        cv_test_costs, cv_test_rmses = [], []
        for train, test in tscv.split(training_data):
            key, sub = jax.random.split(key)
            fold = fit_best(training_data[train], sub)
            Zt, ct = fold.transform(training_data[test])
            cv_test_costs.append(ct)
            cv_test_rmses.append(
                rmse(training_data[test], fold.inverse_transform(Zt)))
        attrs.update({
            'training_set_cost': '{:16.8e}'.format(np.mean(cv_test_costs)),
            'training_set_cost_std': '{:16.8e}'.format(np.std(cv_test_costs)),
            'training_set_rmse': '{:16.8e}'.format(np.mean(cv_test_rmses)),
            'training_set_rmse_std': '{:16.8e}'.format(np.std(cv_test_rmses)),
            'n_folds': '{:d}'.format(n_folds),
        })

    key, sub = jax.random.split(key)
    start = time.perf_counter()
    best = fit_best(training_data, sub)
    elapsed = time.perf_counter() - start
    if not best.avg_time_per_iter:
        best.avg_time_per_iter = elapsed / max(best.n_iter, 1)

    recon = np.asarray(best.inverse_transform(best.weights))
    validation_cost = np.nan
    validation_rmse = np.nan
    if validation_data is not None and len(validation_data):
        Zv, validation_cost = best.transform(validation_data)
        validation_rmse = rmse(validation_data,
                               best.inverse_transform(Zv))

    if not cross_validate:
        attrs.update({
            'training_set_cost': '{:16.8e}'.format(best.cost),
            'training_set_rmse': '{:16.8e}'.format(
                rmse(training_data, recon)),
        })
    attrs.update({
        'training_set_size': '{:d}'.format(training_data.shape[0]),
        'test_set_cost': '{:16.8e}'.format(validation_cost),
        'test_set_rmse': '{:16.8e}'.format(validation_rmse),
        'test_set_size': '{:d}'.format(
            0 if validation_data is None else validation_data.shape[0]),
        'n_iter': '{:d}'.format(best.n_iter),
        'avg_time_per_iter': '{:16.8e}'.format(best.avg_time_per_iter),
        'elapsed_time': '{:16.8e}'.format(elapsed),
        'init': init if init else 'random',
        'n_init': '{:d}'.format(n_init),
        'lambda_W': '{:16.8e}'.format(lambda_W),
        'max_iterations': '{:d}'.format(max_iterations),
        'tolerance': '{:16.8e}'.format(tolerance),
    })

    return best, attrs


def kmeans_analysis(training_data, validation_data, *, n_components,
                    n_init, max_iterations, n_trials, reference,
                    random_seed, init='k-means++', tolerance=1e-4,
                    cross_validate=False, n_folds=10, verbose=False):
    """K-means + gap statistic (template of reference
    bin/run_hadisst_kmeans.py:run_kmeans, including the TimeSeriesSplit
    cross-validation branch, :203-268 — reimplemented without the
    reference's 3-index bug at :268)."""
    key = _as_key(random_seed)
    key, k_fit = jax.random.split(key)

    def fit_model(data, key):
        k_fit, k_gap = jax.random.split(key)
        model = KMeans(n_clusters=n_components, init=init, n_init=n_init,
                       max_iter=max_iterations, tol=tolerance,
                       random_state=k_fit)
        model.fit(data)
        gap, sk = gap_statistic(data, model.inertia_, n_components,
                                n_trials=n_trials, reference=reference,
                                random_state=k_gap)
        return model, gap, sk

    attrs = {}
    if cross_validate:
        from sklearn.model_selection import TimeSeriesSplit
        tscv = TimeSeriesSplit(n_splits=n_folds)
        cv_gaps, cv_sks = [], []
        cv_test_costs, cv_test_rmses = [], []
        for train, test in tscv.split(training_data):
            key, sub = jax.random.split(key)
            fold, fold_gap, fold_sk = fit_model(training_data[train], sub)
            cv_gaps.append(fold_gap)
            cv_sks.append(fold_sk)
            centers = np.asarray(fold.cluster_centers_)
            test_labels = fold.predict(training_data[test])
            test_resid = training_data[test] - centers[test_labels]
            cv_test_costs.append(float(np.sum(test_resid ** 2)))
            cv_test_rmses.append(
                rmse(training_data[test], centers[test_labels]))
        attrs.update({
            'training_set_cost': '{:16.8e}'.format(np.mean(cv_test_costs)),
            'training_set_cost_std': '{:16.8e}'.format(np.std(cv_test_costs)),
            'training_set_rmse': '{:16.8e}'.format(np.mean(cv_test_rmses)),
            'training_set_rmse_std': '{:16.8e}'.format(np.std(cv_test_rmses)),
            'training_set_gap': '{:16.8e}'.format(np.mean(cv_gaps)),
            'training_set_gap_std': '{:16.8e}'.format(np.std(cv_gaps)),
            'training_set_sk': '{:16.8e}'.format(np.mean(cv_sks)),
            'training_set_sk_std': '{:16.8e}'.format(np.std(cv_sks)),
            'n_folds': '{:d}'.format(n_folds),
        })

    start = time.perf_counter()
    model, gap, sk = fit_model(training_data, k_fit)
    elapsed = time.perf_counter() - start

    # One-hot labels as "weights" (reference run_hadisst_kmeans.py:336-345).
    onehot = np.eye(n_components)[model.labels_]

    validation_inertia = np.nan
    if validation_data is not None and len(validation_data):
        vlabels = model.predict(validation_data)
        centers = np.asarray(model.cluster_centers_)
        validation_inertia = float(
            np.sum((validation_data - centers[vlabels]) ** 2))

    if not cross_validate:
        attrs['training_set_inertia'] = '{:16.8e}'.format(model.inertia_)
    attrs.update({
        'training_set_size': '{:d}'.format(training_data.shape[0]),
        'test_set_inertia': '{:16.8e}'.format(validation_inertia),
        'test_set_size': '{:d}'.format(
            0 if validation_data is None else validation_data.shape[0]),
        'gap_statistic': '{:16.8e}'.format(gap),
        'gap_sk': '{:16.8e}'.format(sk),
        'n_trials': '{:d}'.format(n_trials),
        'reference': reference,
        'init': init,
        'n_init': '{:d}'.format(n_init),
        'n_iter': '{:d}'.format(model.n_iter_),
        'max_iterations': '{:d}'.format(max_iterations),
        'tolerance': '{:16.8e}'.format(tolerance),
        'elapsed_time': '{:16.8e}'.format(elapsed),
    })
    return model, onehot, attrs


def pca_analysis(training_data, validation_data, *, n_components,
                 tolerance=1e-8, random_seed=None, verbose=False):
    """PCA/EOF fit + metrics (the reference's ``run_pca`` cell,
    notebooks/hadisst_pca.ipynb: sklearn PCA on the weighted, flattened,
    NaN-masked anomalies; EOFs + PCs + residuals + cost attrs).

    ``training_data``/``validation_data`` are in valid-feature space.
    Returns ``(result, attrs)`` where ``result`` holds ``pcs`` (full
    sample axis, training then validation), ``eofs`` (k, n_valid),
    ``means`` (n_valid,), ``residuals`` (full sample axis, n_valid),
    ``explained_variance``, ``explained_variance_ratio``,
    ``singular_values``.
    """
    from ..models.pca import PCA
    del random_seed  # exact SVD; accepted for signature parity

    n_train = training_data.shape[0]
    n_val = 0 if validation_data is None else validation_data.shape[0]

    start = time.perf_counter()
    model = PCA(n_components=n_components, tol=tolerance)
    pcs = np.asarray(model.fit_transform(training_data))
    elapsed = time.perf_counter() - start

    components = np.asarray(model.components_)
    training_recon = pcs @ components
    training_resid = training_data - training_recon
    training_cost = 0.5 * float(np.sum(training_resid ** 2)) / n_train
    training_rmse = rmse(training_data, training_recon)

    full_pcs = np.full((n_train + n_val, n_components), np.nan)
    full_pcs[:n_train] = pcs
    full_resid = np.full((n_train + n_val, training_data.shape[1]), np.nan)
    full_resid[:n_train] = training_resid

    validation_cost = np.nan
    validation_rmse = np.nan
    if n_val:
        validation_pcs = np.asarray(model.transform(validation_data))
        validation_recon = validation_pcs @ components
        validation_resid = validation_data - validation_recon
        validation_cost = 0.5 * float(np.sum(validation_resid ** 2)) / n_val
        validation_rmse = rmse(validation_data, validation_recon)
        full_pcs[n_train:] = validation_pcs
        full_resid[n_train:] = validation_resid

    attrs = {
        'training_set_cost': '{:16.8e}'.format(training_cost),
        'training_set_size': '{:d}'.format(n_train),
        'training_set_rmse': '{:16.8e}'.format(training_rmse),
        'test_set_cost': '{:16.8e}'.format(validation_cost),
        'test_set_size': '{:d}'.format(n_val),
        'test_set_rmse': '{:16.8e}'.format(validation_rmse),
        'noise_variance': '{:16.8e}'.format(model.noise_variance_),
        'tolerance': '{:16.8e}'.format(tolerance),
        'elapsed_time': '{:16.8e}'.format(elapsed),
    }
    result = {
        'pcs': full_pcs,
        'eofs': components,
        'means': np.asarray(model.mean_),
        'residuals': full_resid,
        'explained_variance': np.asarray(model.explained_variance_),
        'explained_variance_ratio':
            np.asarray(model.explained_variance_ratio_),
        'singular_values': np.asarray(model.singular_values_),
    }
    return result, attrs


def build_output_dataset(*, weights, dictionary_over_samples, patterns,
                         cost_deltas, time_values, time_name, time_attrs,
                         feature_dims, feature_shape, feature_coords,
                         missing_mask, n_components, attrs,
                         pattern_name='archetypes'):
    """Assemble the driver output Dataset (same variable/attr schema as
    the reference drivers' xr.Dataset, run_hadisst_aa.py:292-393)."""
    n_train = weights.shape[0]
    component = Variable(('component',), np.arange(n_components))
    coords = {'component': component}
    if time_values is not None:
        coords[time_name] = Variable((time_name,), time_values[:n_train],
                                     time_attrs or {})
    for name, var in (feature_coords or {}).items():
        coords[name] = var

    full_patterns = restore_missing_features(np.asarray(patterns),
                                             missing_mask)
    full_patterns = full_patterns.reshape([n_components] +
                                          list(feature_shape))

    data_vars = {
        'weights': Variable((time_name, 'component'), np.asarray(weights)),
        'dictionary': Variable(('component', time_name),
                               np.asarray(dictionary_over_samples))
        if dictionary_over_samples is not None else None,
        pattern_name: Variable(tuple(['component'] + list(feature_dims)),
                               full_patterns),
        'cost_deltas': Variable(('iteration',), np.asarray(cost_deltas))
        if cost_deltas is not None else None,
    }
    data_vars = {k: v for k, v in data_vars.items() if v is not None}
    return Dataset(data_vars, coords, dict(attrs))
