"""Padded-k program bucketing: masked sub-simplex solves must equal
unpadded solves exactly.

The model-selection sweep compiles one program per component-count
*bucket* instead of one per ``k`` (round-1 weakness: per-``k``
recompiles dominated the sweep).  Correctness hinges on the masked
weights QP pinning padded components to exact zeros and on padded
dictionary rows receiving exactly zero gradient; these tests pin both
down at every level (projection op, QP solver, fit core, restart API,
sweep).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from convex_dim_red_tpu.ops.simplex_projection import (
    simplex_project_masked, simplex_project_rows)
from convex_dim_red_tpu.solvers.spg import (
    quad_simplex_spg, quad_simplex_spg_batch)
from convex_dim_red_tpu.models.archetypal_analysis import _kernel_aa_core
from convex_dim_red_tpu.models._common import (QPSolverConfig,
                                               SPGSolverConfig)
from convex_dim_red_tpu.parallel.restarts import aa_fit_restarts
from convex_dim_red_tpu.parallel.sweep import aa_model_selection_sweep


def test_masked_projection_equals_subvector_projection():
    rng = np.random.RandomState(0)
    for k, k_pad in [(2, 8), (5, 8), (1, 4), (7, 8)]:
        for scale in [1.0, 1e3, 1e-3]:
            x = rng.standard_normal((10, k_pad)) * scale
            mask = np.arange(k_pad) < k
            out = np.asarray(simplex_project_masked(jnp.asarray(x),
                                                    jnp.asarray(mask)))
            ref = np.asarray(simplex_project_rows(
                jnp.asarray(x[:, :k])))
            assert np.allclose(out[:, :k], ref, atol=1e-14)
            assert np.all(out[:, k:] == 0.0)


def test_masked_projection_all_active_is_plain_projection():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((6, 5))
    out = np.asarray(simplex_project_masked(
        jnp.asarray(x), jnp.ones(5, bool)))
    ref = np.asarray(simplex_project_rows(jnp.asarray(x)))
    assert np.allclose(out, ref, atol=1e-14)


def _padded_qp(rng, k, k_pad, n_rows=7):
    M = rng.standard_normal((k, k + 2))
    A = M @ M.T + 0.1 * np.eye(k)
    A_pad = rng.standard_normal((k_pad, k_pad))
    A_pad = A_pad @ A_pad.T + 0.1 * np.eye(k_pad)
    A_pad[:k, :k] = A
    B = rng.standard_normal((n_rows, k))
    B_pad = rng.standard_normal((n_rows, k_pad))
    B_pad[:, :k] = B
    X0 = rng.dirichlet(np.ones(k), n_rows)
    X0_pad = np.zeros((n_rows, k_pad))
    X0_pad[:, :k] = X0
    return A, B, X0, A_pad, B_pad, X0_pad


@pytest.mark.slow
def test_masked_qp_batch_matches_unpadded_solve():
    """The masked batched QP must follow the identical iterate sequence
    as the unpadded solve on the active block, regardless of the
    (arbitrary) padded entries of A and B."""
    rng = np.random.RandomState(2)
    for k, k_pad in [(3, 8), (5, 16)]:
        A, B, X0, A_pad, B_pad, X0_pad = _padded_qp(rng, k, k_pad)
        mask = jnp.arange(k_pad) < k
        ref = np.asarray(quad_simplex_spg_batch(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(X0)))
        out = np.asarray(quad_simplex_spg_batch(
            jnp.asarray(A_pad), jnp.asarray(B_pad),
            jnp.asarray(X0_pad), mask=mask))
        assert np.all(out[:, k:] == 0.0)
        assert np.allclose(out[:, :k], ref, atol=1e-12)


def test_masked_qp_single_vector():
    rng = np.random.RandomState(3)
    A, B, X0, A_pad, B_pad, X0_pad = _padded_qp(rng, 4, 8, n_rows=1)
    mask = jnp.arange(8) < 4
    ref = np.asarray(quad_simplex_spg(
        jnp.asarray(A), jnp.asarray(B[0]), jnp.asarray(X0[0])))
    out = np.asarray(quad_simplex_spg(
        jnp.asarray(A_pad), jnp.asarray(B_pad[0]),
        jnp.asarray(X0_pad[0]), mask=mask))
    assert np.allclose(out[:4], ref, atol=1e-12)
    assert np.all(out[4:] == 0.0)


def _planted(rng, n_samples=48, k=3, d=5):
    basis = rng.uniform(size=(k, d))
    Z = rng.uniform(size=(n_samples, k))
    Z /= Z.sum(axis=1, keepdims=True)
    idx = rng.choice(n_samples, size=k, replace=False)
    for comp, i in enumerate(idx):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis


def _run_core(X, Z0, C0, mask, max_iterations=40):
    K = jnp.asarray(X) @ jnp.asarray(X).T
    k = C0.shape[0]
    out = _kernel_aa_core(
        K, jnp.asarray(Z0), jnp.asarray(C0), jnp.ones(k, K.dtype),
        jnp.asarray(0.0, K.dtype), jnp.asarray(0.0, K.dtype),
        jnp.asarray(X), mask,
        do_scale=False, do_dict=True, do_weights=True,
        criterion='abs_delta_f', max_iterations=max_iterations,
        require_monotonic=False, has_data=True,
        dict_cfg=SPGSolverConfig(max_iterations=5),
        weights_cfg=QPSolverConfig(), scale_cfg=SPGSolverConfig())
    Z, C, alpha, cost, n_iter, trace, _, _ = out
    return (np.asarray(Z), np.asarray(C), float(cost), int(n_iter),
            np.asarray(trace))


def test_padded_core_trajectory_equals_unpadded():
    """Same active init, k padded 3->8: identical cost trajectory,
    identical iterates on the active block, frozen padded rows."""
    rng = np.random.RandomState(4)
    X = _planted(rng)
    n = X.shape[0]
    k, k_pad = 3, 8

    Z0 = rng.dirichlet(np.ones(k), n)
    C0 = rng.dirichlet(np.ones(n), k)
    Z0_pad = np.zeros((n, k_pad))
    Z0_pad[:, :k] = Z0
    C0_pad = rng.dirichlet(np.ones(n), k_pad)
    C0_pad[:k] = C0

    Z_r, C_r, cost_r, n_iter_r, trace_r = _run_core(X, Z0, C0, None)
    Z_p, C_p, cost_p, n_iter_p, trace_p = _run_core(
        X, Z0_pad, C0_pad, jnp.arange(k_pad) < k)

    assert n_iter_p == n_iter_r
    assert abs(cost_p - cost_r) < 1e-12
    assert np.allclose(trace_p, trace_r, atol=1e-12)
    assert np.allclose(Z_p[:, :k], Z_r, atol=1e-10)
    assert np.allclose(C_p[:k], C_r, atol=1e-10)
    # Padded weights exactly zero; padded dictionary rows frozen.
    assert np.all(Z_p[:, k:] == 0.0)
    assert np.allclose(C_p[k:], C0_pad[k:], atol=1e-15)


@pytest.mark.slow
def test_aa_fit_restarts_padded_reaches_planted_solution():
    rng = np.random.RandomState(5)
    X = _planted(rng)
    res = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), n_init=6,
                          init='random', tolerance=1e-10,
                          max_iterations=300, pad_components_to=8)
    assert res['weights'].shape == (48, 3)
    assert res['dictionary'].shape == (3, 48)
    assert res['archetypes'].shape == (3, 5)
    assert np.allclose(np.asarray(res['weights']).sum(1), 1, atol=1e-10)
    assert res['cost'] < 1e-6  # planted problem: exact recovery


@pytest.mark.slow
def test_sweep_bucketing_matches_per_k_quality():
    """Bucketed sweep costs must match per-k-compiled sweep costs to
    random-restart noise (identical keys => identical active inits =>
    identical trajectories up to masked-PRNG layout; we assert the
    model-selection curve is equivalent at the planted optimum)."""
    rng = np.random.RandomState(6)
    X = _planted(rng, n_samples=40, k=3, d=5)
    ks = [2, 3, 4]
    key = jax.random.PRNGKey(1)
    bucketed = aa_model_selection_sweep(
        X, ks, key, n_init=6, init='random', tolerance=1e-10,
        max_iterations=200, component_bucket=4, restart_chunk=None)
    per_k = aa_model_selection_sweep(
        X, ks, key, n_init=6, init='random', tolerance=1e-10,
        max_iterations=200, component_bucket=None, restart_chunk=None)
    for k in ks:
        assert bucketed[k]['cost'] <= per_k[k]['cost'] * 1.5 + 1e-8
    # Planted k=3: both sweeps must find the exact factorization.
    assert bucketed[3]['cost'] < 1e-6
    assert per_k[3]['cost'] < 1e-6
    # Elbow structure preserved: cost decreases with k.
    costs = [bucketed[k]['cost'] for k in ks]
    assert costs[0] > costs[1]


@pytest.mark.slow
def test_screened_restarts_reach_planted_solution():
    """Two-phase screened restarts (screen -> prune -> resume) must
    recover the planted factorization and report coherent per-restart
    accounting."""
    rng = np.random.RandomState(7)
    X = _planted(rng)
    res = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), n_init=8,
                          init='random', tolerance=1e-10,
                          max_iterations=300,
                          screen_iterations=20, screen_keep=0.5)
    assert res['cost'] < 1e-6
    assert res['weights'].shape == (48, 3)
    assert res['costs'].shape == (8,)
    # Exactly ceil(0.5 * 8) survivors ran past the screening budget.
    deep = np.sum(res['n_iters'] > 20)
    assert deep <= 4
    assert np.allclose(np.asarray(res['weights']).sum(1), 1, atol=1e-10)


@pytest.mark.slow
def test_screened_restarts_match_unscreened_winner():
    """With screen_keep=1.0 every restart survives; the screened run
    must find the same optimum as the unscreened run."""
    rng = np.random.RandomState(8)
    X = _planted(rng)
    kw = dict(n_init=4, init='random', tolerance=1e-10,
              max_iterations=300)
    full = aa_fit_restarts(X, 3, jax.random.PRNGKey(1), **kw)
    screened = aa_fit_restarts(X, 3, jax.random.PRNGKey(1),
                               screen_iterations=15, screen_keep=1.0,
                               **kw)
    assert abs(full['cost'] - screened['cost']) < 1e-8
    assert screened['best_index'] == full['best_index']


@pytest.mark.slow
def test_screened_restarts_on_mesh_match_unsharded():
    """Screened restarts compose with mesh=: both phases shard over the
    restart axis, and same keys -> same screening costs, survivors, and
    final winner as the unsharded screened run."""
    from convex_dim_red_tpu.parallel.mesh import create_mesh
    rng = np.random.RandomState(9)
    X = _planted(rng)
    mesh = create_mesh(shape=(4,), axis_names=('restarts',),
                       devices=jax.devices()[:4])
    kw = dict(n_init=8, init='random', tolerance=1e-10,
              max_iterations=300, screen_iterations=15, screen_keep=0.5)
    plain = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), **kw)
    sharded = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), mesh=mesh,
                              **kw)
    # Converged costs sit at the tolerance/noise floor; the sharded
    # Gram path changes reduction order, so compare at that floor.
    assert sharded['cost'] == pytest.approx(plain['cost'], rel=1e-6,
                                            abs=1e-8)
    assert np.allclose(np.asarray(sharded['costs']),
                       np.asarray(plain['costs']), rtol=1e-6, atol=1e-8)
    assert sharded['n_iters'].shape == (8,)
    # Screening really pruned: at most ceil(0.5*8) ran past the budget.
    assert np.sum(sharded['n_iters'] > 15) <= 4

    # n_init not divisible by the restart axis: tiled pad restarts are
    # masked out of both phases.
    kw7 = dict(kw, n_init=7)
    plain7 = aa_fit_restarts(X, 3, jax.random.PRNGKey(2), **kw7)
    sharded7 = aa_fit_restarts(X, 3, jax.random.PRNGKey(2), mesh=mesh,
                               **kw7)
    assert sharded7['costs'].shape == (7,)
    assert sharded7['cost'] == pytest.approx(plain7['cost'], rel=1e-6,
                                             abs=1e-8)


@pytest.mark.slow
def test_gpnh_screened_restarts_match_and_shard():
    """GPNH screened restarts (screen -> prune -> resume) reach the
    planted optimum and compose with mesh= like the AA path."""
    from convex_dim_red_tpu.parallel.restarts import gpnh_fit_restarts
    from convex_dim_red_tpu.parallel.mesh import create_mesh

    rng = np.random.RandomState(10)
    X = _planted(rng)
    kw = dict(n_init=8, init='random', tolerance=1e-10,
              max_iterations=300, lambda_W=0.0,
              screen_iterations=15, screen_keep=0.5)
    plain = gpnh_fit_restarts(X, 3, jax.random.PRNGKey(0), **kw)
    assert plain['cost'] < 1e-6
    assert plain['costs'].shape == (8,)
    # Exactly ceil(0.5 * 8) survivors ran past the screening budget.
    assert np.sum(plain['n_iters'] > 15) <= 4
    assert np.allclose(np.asarray(plain['weights']).sum(1), 1,
                       atol=1e-10)

    mesh = create_mesh(shape=(4,), axis_names=('restarts',),
                       devices=jax.devices()[:4])
    sharded = gpnh_fit_restarts(X, 3, jax.random.PRNGKey(0), mesh=mesh,
                                **kw)
    assert sharded['cost'] == pytest.approx(plain['cost'], rel=1e-6,
                                            abs=1e-8)
    assert np.allclose(np.asarray(sharded['costs']),
                       np.asarray(plain['costs']), rtol=1e-6, atol=1e-8)


def test_exact_multiple_k_gets_all_true_mask():
    """Round-2 fix: k equal to the bucket size must reuse the masked
    bucket program (all-true mask), not compile a separate maskless
    program — each extra protocol-scale program pays its own
    compilation."""
    from convex_dim_red_tpu.parallel.restarts import _padded_components

    k_fit, mask = _padded_components(4, 4)
    assert k_fit == 4
    assert mask is not None and bool(jnp.all(mask))

    k_fit, mask = _padded_components(3, None)
    assert (k_fit, mask) == (3, None)

    # Pad smaller than k: no padding (caller error tolerated).
    k_fit, mask = _padded_components(5, 4)
    assert (k_fit, mask) == (5, None)


@pytest.mark.slow
def test_pallas_backend_masked_matches_xla():
    """Masked (bucketed) QPs run fused on the Pallas path too (round-2:
    the silent XLA fallback is gone); masked pallas must agree with the
    masked XLA solve and pin masked coordinates to exact zero."""
    rng = np.random.RandomState(13)
    M = rng.standard_normal((8, 10))
    A = jnp.asarray(M @ M.T + 0.1 * np.eye(8))
    B = jnp.asarray(rng.standard_normal((9, 8)))
    X0 = jnp.asarray(rng.dirichlet(np.ones(8), 9))
    mask = jnp.asarray(np.arange(8) < 5)
    ref = np.asarray(quad_simplex_spg_batch(A, B, X0, backend='xla',
                                            mask=mask))
    out = np.asarray(quad_simplex_spg_batch(A, B, X0, backend='pallas',
                                            mask=mask, interpret=True))
    assert np.allclose(out.sum(axis=1), 1.0, atol=1e-8)
    assert np.all(out[:, 5:] == 0.0)
    assert np.allclose(out, ref, atol=5e-5)


@pytest.mark.slow
def test_screened_restarts_compose_with_padding():
    """Screening + component padding together (the bucketed-sweep fast
    path, benchmarks/config5_screened_ab.py): padded components stay
    exactly zero through screen -> prune -> resume, and the planted
    factorization is still recovered."""
    rng = np.random.RandomState(11)
    X = _planted(rng)
    res = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), n_init=8,
                          init='random', tolerance=1e-10,
                          max_iterations=300, pad_components_to=8,
                          screen_iterations=20, screen_keep=0.5)
    assert res['cost'] < 1e-6
    assert res['weights'].shape == (48, 3)
    assert res['costs'].shape == (8,)
    assert np.sum(res['n_iters'] > 20) <= 4
    assert np.allclose(np.asarray(res['weights']).sum(1), 1, atol=1e-10)
