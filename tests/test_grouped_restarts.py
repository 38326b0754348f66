"""Tests for the grouped single-chip restart runners.

``grouped=True`` restructures the restart batch: the weights QP is
batched ACROSS restarts through :func:`quad_simplex_spg_batch_grouped`
and the outer loop freezes converged restarts per-iteration
(``sharded_aa._keep_best_loop``) instead of vmapping whole
``_kernel_aa_core`` fits.  On the GPU this is the production protocol
path (with the fused weights kernel; solvers/spg.py:resolve_qp_backend);
these tests pin the semantics against the legacy vmapped path on the CPU
mesh, where both run the same XLA row solver and must agree to float
tolerance from identical initial states.
"""

import numpy as np
import jax
import pytest

from convex_dim_red_tpu.parallel.mesh import create_mesh
from convex_dim_red_tpu.parallel.restarts import (
    aa_fit_restarts, gpnh_fit_restarts, kernel_aa_fit_restarts)


def _planted(rng, n_samples=64, n_components=3, n_features=6):
    basis = rng.uniform(size=(n_components, n_features))
    Z = rng.uniform(size=(n_samples, n_components))
    Z /= Z.sum(axis=1, keepdims=True)
    return Z @ basis


@pytest.mark.slow
def test_grouped_aa_matches_vmapped():
    X = _planted(np.random.RandomState(0))
    key = jax.random.PRNGKey(0)
    kwargs = dict(tolerance=1e-10, max_iterations=300)
    plain = aa_fit_restarts(X, 3, key, n_init=8, grouped=False, **kwargs)
    grouped = aa_fit_restarts(X, 3, key, n_init=8, grouped=True, **kwargs)
    # Same keys -> bit-identical inits (shared _init_aa_state); the
    # grouped XLA row solver is the same quad_simplex_spg, so per-restart
    # costs and iteration counts must agree.
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(grouped['costs']), rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(plain['n_iters']),
                                  np.asarray(grouped['n_iters']))
    assert grouped['cost'] == pytest.approx(float(grouped['costs'].min()))
    assert np.allclose(np.asarray(grouped['weights']).sum(1), 1,
                       atol=1e-12)


@pytest.mark.slow
def test_grouped_aa_with_scale_factors():
    X = _planted(np.random.RandomState(1))
    key = jax.random.PRNGKey(1)
    kwargs = dict(delta=0.1, tolerance=1e-10, max_iterations=300)
    plain = aa_fit_restarts(X, 3, key, n_init=4, grouped=False, **kwargs)
    grouped = aa_fit_restarts(X, 3, key, n_init=4, grouped=True, **kwargs)
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(grouped['costs']), rtol=1e-7)


@pytest.mark.slow
def test_grouped_aa_screened():
    X = _planted(np.random.RandomState(2))
    key = jax.random.PRNGKey(2)
    kwargs = dict(tolerance=1e-10, max_iterations=300,
                  screen_iterations=20, screen_keep=0.5)
    plain = aa_fit_restarts(X, 3, key, n_init=8, grouped=False, **kwargs)
    grouped = aa_fit_restarts(X, 3, key, n_init=8, grouped=True, **kwargs)
    assert grouped['cost'] == pytest.approx(plain['cost'], rel=1e-8)
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(grouped['costs']), rtol=1e-8)


@pytest.mark.slow
def test_grouped_aa_padded_components():
    X = _planted(np.random.RandomState(3))
    key = jax.random.PRNGKey(3)
    res = aa_fit_restarts(X, 3, key, n_init=4, tolerance=1e-10,
                          max_iterations=300, pad_components_to=5,
                          grouped=True)
    assert res['weights'].shape == (64, 3)
    assert res['dictionary'].shape == (3, 64)
    assert res['cost'] < 1e-3
    assert np.allclose(np.asarray(res['weights']).sum(1), 1, atol=1e-12)


@pytest.mark.slow
def test_grouped_kernel_aa_matches_vmapped():
    X = _planted(np.random.RandomState(4))
    K = X @ X.T
    key = jax.random.PRNGKey(4)
    kwargs = dict(tolerance=1e-10, max_iterations=300)
    plain = kernel_aa_fit_restarts(K, 3, key, n_init=4, grouped=False,
                                   **kwargs)
    grouped = kernel_aa_fit_restarts(K, 3, key, n_init=4, grouped=True,
                                     **kwargs)
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(grouped['costs']), rtol=1e-8)


def test_grouped_gpnh_matches_vmapped():
    X = _planted(np.random.RandomState(5))
    key = jax.random.PRNGKey(5)
    kwargs = dict(lambda_W=0.01, tolerance=1e-10, max_iterations=300)
    plain = gpnh_fit_restarts(X, 3, key, n_init=4, grouped=False,
                              **kwargs)
    grouped = gpnh_fit_restarts(X, 3, key, n_init=4, grouped=True,
                                **kwargs)
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(grouped['costs']), rtol=1e-8)
    np.testing.assert_array_equal(np.asarray(plain['n_iters']),
                                  np.asarray(grouped['n_iters']))


@pytest.mark.slow
def test_grouped_gpnh_screened():
    X = _planted(np.random.RandomState(6))
    key = jax.random.PRNGKey(6)
    kwargs = dict(tolerance=1e-10, max_iterations=300,
                  screen_iterations=15, screen_keep=0.5)
    plain = gpnh_fit_restarts(X, 3, key, n_init=4, grouped=False,
                              **kwargs)
    grouped = gpnh_fit_restarts(X, 3, key, n_init=4, grouped=True,
                                **kwargs)
    assert grouped['cost'] == pytest.approx(plain['cost'], rel=1e-8)


def test_grouped_with_mesh_raises():
    X = _planted(np.random.RandomState(7))
    mesh = create_mesh(shape=(8,), axis_names=("restarts",))
    with pytest.raises(ValueError, match="grouped=True requires"):
        aa_fit_restarts(X, 3, jax.random.PRNGKey(7), n_init=8,
                        mesh=mesh, grouped=True)


def test_grouped_auto_is_legacy_on_cpu():
    """On CPU the auto weights backend resolves to 'xla', so
    ``grouped=None`` keeps the legacy vmapped path (the grouped
    structure only auto-engages where it was measured faster: the
    fused kernel on the GPU; solvers/spg.py:resolve_qp_backend)."""
    from convex_dim_red_tpu.parallel.restarts import _grouped_backend
    from convex_dim_red_tpu.models._common import QPSolverConfig

    cfg = QPSolverConfig(backend='auto')
    assert _grouped_backend(None, None, cfg, 3) is None
    # Explicit pallas request engages the grouped structure even off-GPU
    # (callers opting in, e.g. interpret-mode tests).
    assert _grouped_backend(None, None, QPSolverConfig(
        backend='pallas'), 3) == 'pallas'
    # Forced grouped structure with the resolved (XLA) backend.
    assert _grouped_backend(None, True, cfg, 3) == 'xla'
    # Mesh fits never take the single-chip grouped path implicitly.
    mesh = create_mesh(shape=(8,), axis_names=("restarts",))
    assert _grouped_backend(mesh, None, cfg, 3) is None


@pytest.mark.slow
def test_compacted_aa_matches_grouped_single_call():
    """Convergence compaction is a pure scheduling change: per-restart
    costs, iteration counts, the winner, and the winner's cost-delta
    trace must all equal the one-shot grouped run (state-resuming
    rounds continue the exact trajectory; the carried done flag keeps
    the round boundary from adding spurious iterations)."""
    X = _planted(np.random.RandomState(2))
    key = jax.random.PRNGKey(7)
    kwargs = dict(tolerance=1e-10, max_iterations=300, grouped=True)
    plain = aa_fit_restarts(X, 3, key, n_init=9, **kwargs)
    compact = aa_fit_restarts(X, 3, key, n_init=9, restart_chunk=4,
                              compact_iterations=20, **kwargs)
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(compact['costs']), rtol=1e-10)
    assert np.array_equal(np.asarray(plain['n_iters']),
                          np.asarray(compact['n_iters']))
    assert plain['best_index'] == compact['best_index']
    assert compact['cost'] == pytest.approx(plain['cost'], rel=1e-12)
    assert compact['n_iter'] == plain['n_iter']
    np.testing.assert_allclose(compact['cost_deltas'],
                               plain['cost_deltas'],
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(np.asarray(compact['weights']),
                               np.asarray(plain['weights']),
                               rtol=1e-8, atol=1e-12)


def test_compacted_gpnh_matches_grouped_single_call():
    """GPNH compaction parity (reference protocol applies to GPNH too,
    bin/run_hadisst_gpnh.py:149-171): per-restart costs, iteration
    counts, winner, and the winner's trace equal the one-shot grouped
    run."""
    X = _planted(np.random.RandomState(8))
    key = jax.random.PRNGKey(8)
    kwargs = dict(lambda_W=0.01, tolerance=1e-10, max_iterations=300,
                  grouped=True)
    plain = gpnh_fit_restarts(X, 3, key, n_init=9, **kwargs)
    compact = gpnh_fit_restarts(X, 3, key, n_init=9, restart_chunk=4,
                                compact_iterations=20, **kwargs)
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(compact['costs']), rtol=1e-10)
    assert np.array_equal(np.asarray(plain['n_iters']),
                          np.asarray(compact['n_iters']))
    assert plain['best_index'] == compact['best_index']
    assert compact['cost'] == pytest.approx(plain['cost'], rel=1e-12)
    assert compact['n_iter'] == plain['n_iter']
    np.testing.assert_allclose(compact['cost_deltas'],
                               plain['cost_deltas'],
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(np.asarray(compact['weights']),
                               np.asarray(plain['weights']),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.slow
def test_compacted_kernel_aa_matches_grouped_single_call():
    """KernelAA compaction parity against the one-shot grouped run
    (kernel trace-form cost; same scheduler as AA/GPNH)."""
    X = _planted(np.random.RandomState(9))
    K = X @ X.T
    key = jax.random.PRNGKey(9)
    kwargs = dict(tolerance=1e-10, max_iterations=300, grouped=True)
    plain = kernel_aa_fit_restarts(K, 3, key, n_init=6, **kwargs)
    compact = kernel_aa_fit_restarts(K, 3, key, n_init=6,
                                     restart_chunk=4,
                                     compact_iterations=25, **kwargs)
    assert np.allclose(np.asarray(plain['costs']),
                       np.asarray(compact['costs']), rtol=1e-10)
    assert np.array_equal(np.asarray(plain['n_iters']),
                          np.asarray(compact['n_iters']))
    assert plain['best_index'] == compact['best_index']
    assert compact['cost'] == pytest.approx(plain['cost'], rel=1e-12)


@pytest.mark.slow
def test_kernel_aa_padded_components():
    """pad_components_to on the kernel entry point: result is exactly a
    k-component model (padded components pinned to zero weight), same
    contract as the AA path."""
    X = _planted(np.random.RandomState(10))
    K = X @ X.T
    key = jax.random.PRNGKey(10)
    res = kernel_aa_fit_restarts(K, 3, key, n_init=4, tolerance=1e-10,
                                 max_iterations=300,
                                 pad_components_to=5, grouped=True)
    assert res['weights'].shape == (64, 3)
    assert res['dictionary'].shape == (3, 64)
    assert np.allclose(np.asarray(res['weights']).sum(1), 1, atol=1e-12)
    assert np.isfinite(res['cost'])


@pytest.mark.slow
def test_compacted_aa_respects_iteration_cap_and_validations():
    X = _planted(np.random.RandomState(3))
    key = jax.random.PRNGKey(1)
    # Cap not divisible by the round length: totals must not exceed it.
    res = aa_fit_restarts(X, 3, key, n_init=5, tolerance=1e-14,
                          max_iterations=25, compact_iterations=10,
                          restart_chunk=2)
    assert int(np.max(res['n_iters'])) <= 25
    assert np.isfinite(res['cost'])

    with pytest.raises(ValueError, match='mutually exclusive'):
        aa_fit_restarts(X, 3, key, n_init=4, compact_iterations=10,
                        screen_iterations=5)
    with pytest.raises(ValueError, match='grouped'):
        aa_fit_restarts(X, 3, key, n_init=4, compact_iterations=10,
                        grouped=False)


@pytest.mark.slow
def test_compacted_aa_on_mesh_matches_single_chip():
    """Per-group compaction under mesh= (round-4 verdict item 8): the
    round programs shard over the restart axis, each group compacts its
    local queue, and — because no collectives cross groups and the
    trajectories are the same state-resuming chains — the per-restart
    costs and iteration counts match the single-chip compacted run."""
    X = _planted(np.random.RandomState(4))
    key = jax.random.PRNGKey(2)
    kw = dict(tolerance=1e-10, max_iterations=200,
              compact_iterations=15, restart_chunk=2)
    plain = aa_fit_restarts(X, 3, key, n_init=8, **kw)
    mesh = create_mesh(shape=(4,), axis_names=("restarts",),
                       devices=jax.devices()[:4])
    sharded = aa_fit_restarts(X, 3, key, n_init=8, mesh=mesh, **kw)
    assert sharded['cost'] == pytest.approx(plain['cost'], rel=1e-10)
    assert np.allclose(np.asarray(sharded['costs']),
                       np.asarray(plain['costs']), rtol=1e-8)
    np.testing.assert_array_equal(np.asarray(sharded['n_iters']),
                                  np.asarray(plain['n_iters']))

    # n_init not divisible by the restart axis: pad restarts are
    # excluded from scheduling and selection.
    plain7 = aa_fit_restarts(X, 3, jax.random.PRNGKey(3), n_init=7,
                             **kw)
    sharded7 = aa_fit_restarts(X, 3, jax.random.PRNGKey(3), n_init=7,
                               mesh=mesh, **kw)
    assert sharded7['costs'].shape == (7,)
    assert sharded7['cost'] == pytest.approx(plain7['cost'], rel=1e-10)


@pytest.mark.slow
def test_compacted_gpnh_on_mesh_matches_single_chip():
    from convex_dim_red_tpu.parallel.restarts import gpnh_fit_restarts
    X = _planted(np.random.RandomState(5))
    key = jax.random.PRNGKey(4)
    kw = dict(tolerance=1e-10, max_iterations=200, lambda_W=1e-3,
              compact_iterations=15, restart_chunk=2)
    plain = gpnh_fit_restarts(X, 3, key, n_init=8, **kw)
    mesh = create_mesh(shape=(4,), axis_names=("restarts",),
                       devices=jax.devices()[:4])
    sharded = gpnh_fit_restarts(X, 3, key, n_init=8, mesh=mesh, **kw)
    assert sharded['cost'] == pytest.approx(plain['cost'], rel=1e-10)
    assert np.allclose(np.asarray(sharded['costs']),
                       np.asarray(plain['costs']), rtol=1e-8)
    np.testing.assert_array_equal(np.asarray(sharded['n_iters']),
                                  np.asarray(plain['n_iters']))
