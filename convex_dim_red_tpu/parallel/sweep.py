"""Model-selection sweeps: k = 2..K x N restarts, sharded over a mesh.

The stretch benchmark config (BASELINE.md config 5): batched
multi-restart AA/GPNH sweeps across component counts.  Within a ``k``
all restarts run as one sharded on-device batch; across ``k`` the AA
sweep pads component counts to bucket sizes (``component_bucket``)
with a runtime mask pinning padded components to zero weight, so a
whole bucket of ``k`` values reuses ONE compiled program instead of
recompiling per shape (a sweep k=2..20 collapses from 7 programs to
2-3; each padded fit is exactly a ``k``-component model — see
``restarts.aa_fit_restarts(pad_components_to)``).  Results aggregate
into the model-selection table the analysis notebooks consume.

The GPNH sweep buckets the same way: although its pairwise
dictionary-distance penalty couples all columns (reference
gpnh_convex_coding.py:179-196), the masked penalty evaluates the
active-``k`` prefactor over active columns only
(``models.gpnh_convex_coding.gpnh_regularization_masked``), so a
padded fit optimizes exactly the ``k``-component objective.  K-means
sweeps cannot bucket this way (the padded-centroid analog changes
Lloyd assignments).
"""

import os
import time

import jax
import numpy as np

from .restarts import aa_fit_restarts, gpnh_fit_restarts
from ..models.kmeans import KMeans, gap_statistic

__all__ = ["aa_model_selection_sweep", "gpnh_model_selection_sweep",
           "kmeans_model_selection_sweep"]


def _sweep_fingerprint(data, key, params):
    """Cheap config fingerprint stored with each sweep checkpoint: a
    resumed sweep must be the SAME sweep (same data, key, and
    hyperparameters), otherwise k-points silently mix incompatible
    configurations."""
    X = np.asarray(data)
    probe = (tuple(X.shape), str(X.dtype),
             float(X.sum(dtype=np.float64)),
             np.asarray(key).tobytes().hex(),
             tuple(sorted((k, repr(v)) for k, v in params.items())))
    return repr(probe)


def _sweep_ckpt_load(checkpoint_dir, k, fingerprint):
    """Load a completed sweep point, or None.  Sweep checkpointing is
    the long-multi-restart-sweep resume mechanism SURVEY.md §5 calls
    for (the reference has none; its sweeps are notebook loops).
    Entries whose stored fingerprint does not match the current
    sweep's configuration are ignored (and recomputed) with a
    warning."""
    if checkpoint_dir is None:
        return None
    path = os.path.join(checkpoint_dir, "k_%03d.npz" % k)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        entry = {name: (data[name].item() if data[name].ndim == 0
                        else data[name]) for name in data.files}
    if entry.pop('_fingerprint', None) != fingerprint:
        import warnings
        warnings.warn(
            "sweep checkpoint %s was written by a different sweep "
            "configuration (data/key/params changed); recomputing"
            % path, UserWarning)
        return None
    return entry


def _sweep_ckpt_save(checkpoint_dir, k, entry, fingerprint):
    if checkpoint_dir is None:
        return
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "k_%03d.npz" % k)
    np.savez(path, _fingerprint=fingerprint,
             **{name: np.asarray(val) for name, val in entry.items()})


def aa_model_selection_sweep(data, ks, key, n_init=50, delta=0.0,
                             init='furthest_sum', tolerance=1e-5,
                             stopping_criterion='rel_delta_f',
                             max_iterations=500, mesh=None,
                             validation_data=None, restart_chunk=10,
                             component_bucket=None, checkpoint_dir=None,
                             **solver_kwargs):
    """Fit AA for every k in ``ks`` with ``n_init`` sharded restarts.

    ``component_bucket`` rounds each ``k`` up to the next multiple of
    the bucket size for compilation (padded components are masked to
    exact zeros, so results are true ``k``-component fits); every ``k``
    in a bucket shares one compiled program.  Off by default: padding
    changes the restart *initializations* (masked-uniform weights;
    FurthestSum refinement sees the padded count), so bucketed per-k
    costs differ from the reference per-k protocol — opt in when the
    compile amortization matters more (see benchmarks/run_all.py
    config5: 7 programs collapse to 3).

    ``checkpoint_dir=`` makes the sweep resumable: each completed
    ``k`` is persisted (``k_NNN.npz``) and skipped on rerun.  The PRNG
    key is split per ``k`` regardless of skipping, so a resumed sweep
    computes exactly what the uninterrupted sweep would have.

    Returns ``{k: {'cost', 'rmse', 'n_iter', 'elapsed', ...}}`` suitable
    for :func:`pipelines.analysis.model_selection_table`.
    """
    fp = _sweep_fingerprint(data, key, dict(
        n_init=n_init, delta=delta, init=init, tolerance=tolerance,
        stopping_criterion=stopping_criterion,
        max_iterations=max_iterations,
        component_bucket=component_bucket, **solver_kwargs))
    results = {}
    for k in ks:
        k = int(k)
        pad_to = None
        if component_bucket:
            bucket = int(component_bucket)
            pad_to = -(-k // bucket) * bucket
        key, sub = jax.random.split(key)
        done = _sweep_ckpt_load(checkpoint_dir, k, fp)
        if done is not None:
            results[k] = done
            continue
        start = time.perf_counter()
        fit = aa_fit_restarts(
            data, k, sub, n_init, delta=delta, init=init,
            tolerance=tolerance, stopping_criterion=stopping_criterion,
            max_iterations=max_iterations, mesh=mesh,
            restart_chunk=restart_chunk, pad_components_to=pad_to,
            **solver_kwargs)
        elapsed = time.perf_counter() - start

        recon = np.asarray(fit['weights'] @ fit['archetypes'])
        entry = {
            'cost': fit['cost'],
            'rmse': float(np.sqrt(np.mean(
                (recon - np.asarray(data)) ** 2))),
            'n_iter': fit['n_iter'],
            'elapsed': elapsed,
            'costs': np.asarray(fit['costs']),
        }
        results[int(k)] = entry
        _sweep_ckpt_save(checkpoint_dir, k, entry, fp)
    return results



def gpnh_model_selection_sweep(data, ks, key, n_init=50, lambda_W=0.0,
                               init='random', tolerance=1e-5,
                               stopping_criterion='rel_delta_f',
                               max_iterations=500, mesh=None,
                               restart_chunk=10, component_bucket=None,
                               checkpoint_dir=None,
                               **solver_kwargs):
    """Fit GPNH convex coding for every k with ``n_init`` restarts.

    GPNH analog of :func:`aa_model_selection_sweep` (the analysis
    notebooks' cost-vs-k selection curves cover GPNH runs too).
    ``component_bucket`` buckets component counts exactly like the AA
    sweep: each ``k`` rounds up to the next bucket multiple and runs
    padded with a runtime mask — the masked GPNH penalty uses the
    ACTIVE-``k`` prefactor over active columns, so the padded fit
    optimizes exactly the ``k``-component objective and every ``k`` in
    a bucket reuses ONE compiled program (see
    ``restarts.gpnh_fit_restarts(pad_components_to)``).  Off by
    default: padding changes the restart initializations (masked-
    uniform weights; the random-dictionary scale stays the active-k
    value), so bucketed per-k costs differ from the per-k protocol at
    random-restart-noise level.  ``restart_chunk`` bounds how many
    restarts run in one device execution (see
    restarts._keep_best_over_chunks; the bound is not yet measured on
    the H100).

    ``checkpoint_dir=`` resumes like :func:`aa_model_selection_sweep`.

    Returns ``{k: {'cost', 'rmse', 'n_iter', 'elapsed', 'costs'}}``.
    """
    X = np.asarray(data)
    fp = _sweep_fingerprint(data, key, dict(
        n_init=n_init, lambda_W=lambda_W, init=init,
        tolerance=tolerance, stopping_criterion=stopping_criterion,
        max_iterations=max_iterations,
        component_bucket=component_bucket, **solver_kwargs))
    results = {}
    for k in ks:
        k = int(k)
        pad_to = None
        if component_bucket:
            bucket = int(component_bucket)
            pad_to = -(-k // bucket) * bucket
        key, sub = jax.random.split(key)
        done = _sweep_ckpt_load(checkpoint_dir, k, fp)
        if done is not None:
            results[k] = done
            continue
        start = time.perf_counter()
        fit = gpnh_fit_restarts(
            data, k, sub, n_init, lambda_W=lambda_W, init=init,
            tolerance=tolerance, stopping_criterion=stopping_criterion,
            max_iterations=max_iterations, mesh=mesh,
            restart_chunk=restart_chunk, pad_components_to=pad_to,
            **solver_kwargs)
        elapsed = time.perf_counter() - start
        recon = np.asarray(fit['weights'] @ fit['dictionary'].T)
        results[k] = {
            'cost': fit['cost'],
            'rmse': float(np.sqrt(np.mean((recon - X) ** 2))),
            'n_iter': fit['n_iter'],
            'elapsed': elapsed,
            'costs': np.asarray(fit['costs']),
        }
        _sweep_ckpt_save(checkpoint_dir, k, results[k], fp)
    return results


def kmeans_model_selection_sweep(data, ks, key, n_init=10, n_trials=100,
                                 reference='uniform', max_iter=300,
                                 mesh=None, checkpoint_dir=None):
    """K-means + gap statistic for every k (the reference's gap-based
    model selection, kmeans.py:81-108 + notebooks).

    ``mesh=`` runs each fit as the sharded SPMD k-means
    (samples x restarts) and distributes the gap-statistic reference
    trials over the mesh's restart axis (``n_trials`` rounded up to a
    multiple of the axis size — the estimate just uses a few more
    Monte-Carlo draws).
    """
    if mesh is not None:
        from .mesh import ensure_mesh_axes
        from .sharded_models import sharded_gap_statistic
        mesh = ensure_mesh_axes(mesh)
        r_shards = mesh.shape['restarts']
        n_trials_eff = -(-int(n_trials) // r_shards) * r_shards

    fp = _sweep_fingerprint(data, key, dict(
        n_init=n_init, n_trials=n_trials, reference=reference,
        max_iter=max_iter, sharded=mesh is not None))
    results = {}
    for k in ks:
        key, k_fit, k_gap = jax.random.split(key, 3)
        done = _sweep_ckpt_load(checkpoint_dir, int(k), fp)
        if done is not None:
            results[int(k)] = done
            continue
        start = time.perf_counter()
        model = KMeans(n_clusters=int(k), n_init=n_init,
                       max_iter=max_iter, random_state=k_fit,
                       mesh=mesh).fit(data)
        if mesh is None:
            gap, sk = gap_statistic(data, model.inertia_, int(k),
                                    n_trials=n_trials,
                                    reference=reference,
                                    random_state=k_gap)
        else:
            # Reference-trial fits keep sharded_gap_statistic's own
            # n_init/max_iter defaults — the same ones the
            # single-device gap_statistic uses internally.
            gap, sk = sharded_gap_statistic(
                mesh, data, model.inertia_, int(k),
                n_trials=n_trials_eff, reference=reference,
                random_state=k_gap, trial_axis='restarts')
        results[int(k)] = {
            'cost': model.inertia_,
            'gap': gap,
            'gap_sk': sk,
            'n_iter': model.n_iter_,
            'elapsed': time.perf_counter() - start,
        }
        _sweep_ckpt_save(checkpoint_dir, int(k), results[int(k)], fp)
    return results
