"""Tests for the parallel layer on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from convex_dim_red_tpu.parallel.mesh import create_mesh
from convex_dim_red_tpu.parallel.restarts import aa_fit_restarts
from convex_dim_red_tpu.parallel.sharded_aa import (
    distributed_gram, sharded_aa_train_step)
from convex_dim_red_tpu.models.archetypal_analysis import kernel_aa_cost


def _planted(rng, n_samples=64, n_components=3, n_features=6):
    basis = rng.uniform(size=(n_components, n_features))
    Z = rng.uniform(size=(n_samples, n_components))
    Z /= Z.sum(axis=1, keepdims=True)
    idx = rng.choice(n_samples, size=n_components, replace=False)
    for comp, i in enumerate(idx):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis, idx


def test_eight_cpu_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_vmapped_restarts_beat_single_fit():
    rng = np.random.RandomState(0)
    X, idx = _planted(rng)

    result = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), n_init=8,
                             tolerance=1e-10, max_iterations=300)
    assert result['weights'].shape == (64, 3)
    assert np.allclose(np.asarray(result['weights']).sum(1), 1, atol=1e-10)
    assert result['costs'].shape == (8,)
    # Best-of-8 is the minimum of the batch.
    assert result['cost'] == pytest.approx(float(result['costs'].min()))
    # Planted problem: best restart should essentially reach zero cost.
    assert result['cost'] < 1e-6


@pytest.mark.slow
def test_restarts_on_mesh_match_unsharded():
    rng = np.random.RandomState(1)
    X, _ = _planted(rng)

    mesh = create_mesh(shape=(8,), axis_names=("restarts",))
    res_sharded = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), n_init=8,
                                  tolerance=1e-10, max_iterations=300,
                                  mesh=mesh)
    res_plain = aa_fit_restarts(X, 3, jax.random.PRNGKey(0), n_init=8,
                                tolerance=1e-10, max_iterations=300)
    # Same keys, same math: costs agree to float tolerance.
    assert np.allclose(np.asarray(res_sharded['costs']),
                       np.asarray(res_plain['costs']), rtol=1e-8)


def test_distributed_gram_matches_dense():
    rng = np.random.RandomState(2)
    X = rng.standard_normal((24, 16))
    mesh = create_mesh(shape=(8,), axis_names=("samples",))
    K = np.asarray(distributed_gram(mesh, jnp.asarray(X),
                                    feature_axis="samples"))
    assert np.allclose(K, X @ X.T, atol=1e-10)


def test_sharded_aa_train_step_matches_single_device_math():
    rng = np.random.RandomState(3)
    n, k, d, R = 32, 3, 6, 4
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=d)

    Zs = rng.uniform(size=(R, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(R, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    alphas = np.ones((R, k))

    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))

    Zs_new, Cs_new, alphas_new, costs = jax.jit(
        lambda X, Zs, Cs, alphas: sharded_aa_train_step(
            mesh, X, Zs, Cs, alphas,
            dict_iterations=3, weights_iterations=20))(
        jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas))

    Zs_new = np.asarray(Zs_new)
    Cs_new = np.asarray(Cs_new)
    costs = np.asarray(costs)

    K = X @ X.T
    for r in range(R):
        # Feasibility preserved.
        assert np.allclose(Zs_new[r].sum(axis=1), 1, atol=1e-10)
        assert np.allclose(Cs_new[r].sum(axis=1), 1, atol=1e-10)
        # One alternating step decreases the objective.
        before = float(kernel_aa_cost(K, Zs[r], Cs[r], alphas[r]))
        after = float(kernel_aa_cost(K, Zs_new[r], Cs_new[r],
                                     alphas_new[r]))
        assert after <= before + 1e-12
        # Reported cost matches the recomputed objective.
        assert abs(after - costs[r]) < 1e-8


@pytest.mark.slow
def test_sharded_step_invariant_to_mesh_shape():
    rng = np.random.RandomState(4)
    n, k, d, R = 16, 2, 4, 2
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=d)
    Zs = rng.uniform(size=(R, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(R, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    alphas = np.ones((R, k))

    outs = []
    for shape in [(1, 8), (2, 4), (2, 2)]:
        n_dev = shape[0] * shape[1]
        mesh = create_mesh(shape=shape, axis_names=("restarts", "samples"),
                           devices=jax.devices()[:n_dev])
        Zn, Cn, an, costs = jax.jit(
            lambda X, Zs, Cs, alphas, mesh=mesh: sharded_aa_train_step(
                mesh, X, Zs, Cs, alphas,
                dict_iterations=2, weights_iterations=10))(
            jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
            jnp.asarray(alphas))
        outs.append((np.asarray(Zn), np.asarray(Cn), np.asarray(costs)))

    for Zn, Cn, costs in outs[1:]:
        assert np.allclose(Zn, outs[0][0], atol=1e-8)
        assert np.allclose(Cn, outs[0][1], atol=1e-8)
        assert np.allclose(costs, outs[0][2], atol=1e-10)


@pytest.mark.slow
def test_kernel_aa_fit_restarts_matches_data_space():
    from convex_dim_red_tpu.parallel.restarts import kernel_aa_fit_restarts
    rng = np.random.RandomState(9)
    X, idx = _planted(rng)
    K = X @ X.T
    result = kernel_aa_fit_restarts(K, 3, jax.random.PRNGKey(0), n_init=6,
                                    tolerance=1e-10, max_iterations=300)
    assert result['weights'].shape == (64, 3)
    assert np.allclose(np.asarray(result['weights']).sum(1), 1, atol=1e-10)
    assert result['cost'] < 1e-6
    # Hull recovery: dictionary rows peak at the planted vertices.
    got = sorted(np.asarray(result['dictionary']).argmax(1).tolist())
    assert got == sorted(idx.tolist())


@pytest.mark.slow
def test_kernel_aa_screened_restarts_reach_planted_solution():
    from convex_dim_red_tpu.parallel.restarts import kernel_aa_fit_restarts
    rng = np.random.RandomState(9)
    X, idx = _planted(rng)
    K = X @ X.T
    result = kernel_aa_fit_restarts(K, 3, jax.random.PRNGKey(0),
                                    n_init=8, tolerance=1e-10,
                                    max_iterations=300,
                                    screen_iterations=15,
                                    screen_keep=0.5)
    assert result['cost'] < 1e-6
    assert result['costs'].shape == (8,)
    # Only the kept fraction ran past the screening budget.
    assert np.sum(result['n_iters'] > 15) <= 4
    got = sorted(np.asarray(result['dictionary']).argmax(1).tolist())
    assert got == sorted(idx.tolist())


@pytest.mark.slow
def test_aa_fit_restarts_chunking_matches_single_call():
    rng = np.random.RandomState(10)
    X, _ = _planted(rng)
    a = aa_fit_restarts(X, 3, jax.random.PRNGKey(3), n_init=8,
                        tolerance=1e-10, max_iterations=200)
    b = aa_fit_restarts(X, 3, jax.random.PRNGKey(3), n_init=8,
                        tolerance=1e-10, max_iterations=200,
                        restart_chunk=3)
    assert np.allclose(np.asarray(a['costs']), np.asarray(b['costs']),
                       rtol=1e-10)
    assert a['best_index'] == b['best_index']
    assert a['cost'] == pytest.approx(b['cost'])


# ---------------------------------------------------------------------------
# Sharded fit-to-convergence (round 2)
# ---------------------------------------------------------------------------


def _random_aa_state(rng, R, n, k):
    Zs = rng.uniform(size=(R, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(R, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    return Zs, Cs


def _unsharded_aa_fit(X, Zs, Cs, alphas, *, delta, tolerance,
                      max_iterations, criterion, dict_kwargs,
                      weights_kwargs):
    """Reference trajectory: the single-device core on each restart."""
    from convex_dim_red_tpu.models._common import (QPSolverConfig,
                                                   SPGSolverConfig)
    from convex_dim_red_tpu.models.archetypal_analysis import \
        _kernel_aa_core

    K = jnp.asarray(X) @ jnp.asarray(X).T
    dict_cfg = SPGSolverConfig(**(dict_kwargs or {}))
    weights_cfg = QPSolverConfig(**(weights_kwargs or {}))
    outs = []
    for r in range(Zs.shape[0]):
        out = _kernel_aa_core(
            K, jnp.asarray(Zs[r]), jnp.asarray(Cs[r]),
            jnp.asarray(alphas[r]), jnp.asarray(delta, K.dtype),
            jnp.asarray(tolerance, K.dtype), jnp.asarray(X),
            do_scale=delta != 0, do_dict=True, do_weights=True,
            criterion=criterion, max_iterations=max_iterations,
            require_monotonic=False, has_data=True, dict_cfg=dict_cfg,
            weights_cfg=weights_cfg, scale_cfg=SPGSolverConfig())
        outs.append(out[:7])
    return outs


@pytest.mark.slow
def test_sharded_aa_fit_matches_single_device_trajectory():
    from convex_dim_red_tpu.parallel.sharded_aa import sharded_aa_fit

    rng = np.random.RandomState(5)
    n, k, d, R = 32, 3, 6, 4
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=d)
    Zs, Cs = _random_aa_state(rng, R, n, k)
    alphas = np.ones((R, k))

    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))
    result = sharded_aa_fit(
        mesh, jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas), tolerance=1e-10, max_iterations=60,
        stopping_criterion='abs_delta_f')

    refs = _unsharded_aa_fit(
        X, Zs, Cs, alphas, delta=0.0, tolerance=1e-10,
        max_iterations=60, criterion='abs_delta_f',
        dict_kwargs=None, weights_kwargs=None)

    ref_costs = np.array([float(o[3]) for o in refs])
    ref_iters = np.array([int(o[4]) for o in refs])
    costs = np.asarray(result['costs'])
    n_iters = np.asarray(result['n_iters'])

    assert np.allclose(costs, ref_costs, rtol=1e-8, atol=1e-12)
    assert np.array_equal(n_iters, ref_iters)

    # Keep-best: the returned state is the argmin restart and its
    # cost-delta trajectory matches the single-device core's.
    best = int(np.argmin(ref_costs))
    assert float(result['cost']) == pytest.approx(ref_costs[best])
    ref_trace = np.asarray(refs[best][5])[:ref_iters[best]]
    got_trace = np.asarray(result['cost_deltas'])[:int(result['n_iter'])]
    # Deltas are differences of O(1) costs accumulated in different
    # reduction orders; late-stage deltas ~1e-10 carry absolute noise
    # of ~eps * cost_scale.
    assert got_trace.shape == ref_trace.shape
    assert np.allclose(got_trace, ref_trace, rtol=1e-4, atol=1e-9)
    assert np.allclose(np.asarray(result['weights']).sum(axis=1), 1.0,
                       atol=1e-10)


@pytest.mark.slow
def test_sharded_aa_fit_updates_alpha_with_delta():
    from convex_dim_red_tpu.parallel.sharded_aa import sharded_aa_fit

    rng = np.random.RandomState(6)
    n, k, d, R = 16, 2, 4, 2
    # Scale the data so alpha must move off 1 to fit well.
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=d)
    Zs, Cs = _random_aa_state(rng, R, n, k)
    alphas = np.ones((R, k))
    delta = 0.3

    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))
    result = sharded_aa_fit(
        mesh, jnp.asarray(1.2 * X), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas), delta=delta, tolerance=1e-10,
        max_iterations=40)

    alpha = np.asarray(result['alpha'])
    # The SPMD path really updates alpha (was a pass-through in round 1)
    # and respects the box constraint.
    assert not np.allclose(alpha, 1.0)
    assert (alpha >= 1 - delta - 1e-12).all()
    assert (alpha <= 1 + delta + 1e-12).all()

    refs = _unsharded_aa_fit(
        1.2 * X, Zs, Cs, alphas, delta=delta, tolerance=1e-10,
        max_iterations=40, criterion='abs_delta_f',
        dict_kwargs=None, weights_kwargs=None)
    ref_costs = np.array([float(o[3]) for o in refs])
    # Exactly fittable planted data: both paths drive the cost to ~0;
    # compare at the absolute noise floor of the optimum.
    assert np.allclose(np.asarray(result['costs']), ref_costs,
                       rtol=1e-6, atol=1e-9)


@pytest.mark.slow
def test_sharded_gpnh_fit_matches_single_device():
    from convex_dim_red_tpu.models._common import QPSolverConfig
    from convex_dim_red_tpu.models.gpnh_convex_coding import _gpnh_core
    from convex_dim_red_tpu.parallel.sharded_aa import sharded_gpnh_fit

    rng = np.random.RandomState(7)
    n, k, d, R = 32, 3, 6, 4
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=d)
    Zs, _ = _random_aa_state(rng, R, n, k)
    Ws = rng.standard_normal((R, d, k))
    lam = 1e-3

    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))
    result = sharded_gpnh_fit(
        mesh, jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Ws),
        lambda_W=lam, tolerance=1e-10, max_iterations=60)

    ref_costs = []
    for r in range(R):
        out = _gpnh_core(
            jnp.asarray(X), jnp.asarray(Zs[r]), jnp.asarray(Ws[r]),
            jnp.asarray(lam), jnp.asarray(1e-10),
            do_dict=True, do_weights=True, criterion='abs_delta_f',
            max_iterations=60, require_monotonic=False,
            weights_cfg=QPSolverConfig())
        ref_costs.append(float(out[2]))

    assert np.allclose(np.asarray(result['costs']), np.array(ref_costs),
                       rtol=1e-8, atol=1e-12)
    assert float(result['cost']) == pytest.approx(min(ref_costs))
    assert np.allclose(np.asarray(result['weights']).sum(axis=1), 1.0,
                       atol=1e-10)


def test_restart_sharding_is_structural():
    """shard_map guarantees each restart group computes only its local
    keys; this asserts the partitioning instead of trusting XLA
    auto-sharding (round-1 weakness)."""
    from convex_dim_red_tpu.parallel.restarts import _make_aa_run
    from convex_dim_red_tpu.models._common import (QPSolverConfig,
                                                   SPGSolverConfig)

    rng = np.random.RandomState(8)
    X, _ = _planted(rng)
    mesh = create_mesh(shape=(8,), axis_names=("restarts",))

    run = _make_aa_run(
        mesh, 'restarts', n_components=3, init='random',
        max_iterations=50, n_extra_steps=10, criterion='abs_delta_f',
        do_scale=False, has_data=True, dict_cfg=SPGSolverConfig(),
        weights_cfg=QPSolverConfig(), scale_cfg=SPGSolverConfig())

    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    n_valid = jnp.asarray(8, jnp.int32)
    lowered = run.lower(jnp.asarray(X), keys,
                        jnp.asarray(0.0, X.dtype),
                        jnp.asarray(1e-8, X.dtype), None, n_valid)
    compiled = lowered.compile()
    out = run(jnp.asarray(X), keys, jnp.asarray(0.0, X.dtype),
              jnp.asarray(1e-8, X.dtype), None, n_valid)
    costs = out[4]
    # Per-restart costs come back sharded over the restart axis: one
    # cost per device, never replicated.
    assert len(costs.sharding.device_set) == 8
    shard_shapes = {s.data.shape for s in costs.addressable_shards}
    assert shard_shapes == {(1,)}
    # The keep-best selection crosses the mesh: the compiled module
    # must contain collectives.
    hlo = compiled.as_text()
    assert ('all-reduce' in hlo) or ('all-gather' in hlo), \
        "expected cross-restart collectives in the compiled module"


@pytest.mark.slow
def test_mesh_restarts_fewer_than_axis_size():
    """Regression: n_init smaller than the mesh restart axis needs a
    pad larger than the batch itself; _pad_keys must tile, not slice
    (under-padding crashed shard_map with a divisibility error)."""
    rng = np.random.RandomState(11)
    X = rng.standard_normal((16, 5))
    mesh = create_mesh(shape=(8,), axis_names=("restarts",))
    res = aa_fit_restarts(X, 2, jax.random.PRNGKey(0), n_init=3,
                          init='random', tolerance=1e-8,
                          max_iterations=40, mesh=mesh)
    assert res['costs'].shape == (3,)
    assert np.isfinite(res['cost'])

    from convex_dim_red_tpu.parallel.restarts import gpnh_fit_restarts
    gres = gpnh_fit_restarts(X, 2, jax.random.PRNGKey(1), n_init=3,
                             tolerance=1e-8, max_iterations=40,
                             mesh=mesh)
    assert gres['costs'].shape == (3,)
    assert np.isfinite(gres['cost'])


def test_sharded_fit_rejects_unknown_backend():
    """'pallas' is now a supported sharded weights backend (grouped
    kernel); anything else must still fail loudly instead of silently
    running XLA."""
    import pytest
    from convex_dim_red_tpu.parallel.sharded_aa import sharded_aa_fit
    rng = np.random.RandomState(12)
    X = rng.standard_normal((16, 5))
    Zs = rng.dirichlet(np.ones(2), (2, 16))
    Cs = rng.dirichlet(np.ones(16), (2, 2))
    alphas = np.ones((2, 2))
    mesh = create_mesh(shape=(1, 8), axis_names=("restarts", "samples"))
    with pytest.raises(ValueError, match="backend"):
        sharded_aa_fit(mesh, X, Zs, Cs, alphas,
                       weights_solver_kwargs={'backend': 'numba'})


@pytest.mark.slow
def test_mesh_partial_final_chunk_masks_pad_restarts():
    """Runtime n_valid (round-2 fix): a final partial chunk is tiled up
    to the mesh axis size but its pad restarts must be excluded from
    keep-best and from the reported per-restart arrays, and chunked
    results must equal the unchunked mesh run restart-for-restart."""
    rng = np.random.RandomState(21)
    X, _ = _planted(rng)
    mesh = create_mesh(shape=(4,), axis_names=("restarts",),
                       devices=jax.devices()[:4])

    kwargs = dict(init='random', tolerance=1e-8, max_iterations=60,
                  mesh=mesh)
    full = aa_fit_restarts(X, 3, jax.random.PRNGKey(5), n_init=6,
                           **kwargs)
    chunked = aa_fit_restarts(X, 3, jax.random.PRNGKey(5), n_init=6,
                              restart_chunk=4, **kwargs)
    assert chunked['costs'].shape == (6,)
    # Different chunk batch shapes change matmul reduction order, so
    # per-restart costs agree only to accumulated float noise; the
    # semantics under test are the pad-restart exclusion and keep-best.
    assert np.allclose(chunked['costs'], full['costs'],
                       rtol=1e-2, atol=1e-10)
    assert chunked['cost'] == pytest.approx(full['cost'], rel=1e-2)
    assert chunked['best_index'] == full['best_index']


@pytest.mark.slow
def test_gpnh_restart_chunk_equivalence():
    """GPNH restart chunking (bounded device executions) must keep
    identical keep-best semantics to the single-execution run."""
    from convex_dim_red_tpu.parallel.restarts import gpnh_fit_restarts
    rng = np.random.RandomState(22)
    X, _ = _planted(rng, n_samples=40)

    kwargs = dict(tolerance=1e-9, max_iterations=60, init='random')
    full = gpnh_fit_restarts(X, 3, jax.random.PRNGKey(7), n_init=9,
                             **kwargs)
    chunked = gpnh_fit_restarts(X, 3, jax.random.PRNGKey(7), n_init=9,
                                restart_chunk=4, **kwargs)
    assert chunked['costs'].shape == (9,)
    assert np.allclose(chunked['costs'], full['costs'],
                       rtol=1e-12, atol=1e-14)
    assert chunked['cost'] == pytest.approx(full['cost'])
    assert chunked['best_index'] == full['best_index']


@pytest.mark.slow
def test_mesh_with_padded_components_matches_unsharded():
    """Padded-k bucketing composed with mesh sharding: the component
    mask rides shard_map as a replicated runtime operand."""
    rng = np.random.RandomState(23)
    X, _ = _planted(rng)
    mesh = create_mesh(shape=(8,), axis_names=("restarts",))

    kwargs = dict(init='random', tolerance=1e-9, max_iterations=150,
                  pad_components_to=8)
    sharded = aa_fit_restarts(X, 3, jax.random.PRNGKey(9), n_init=8,
                              mesh=mesh, **kwargs)
    plain = aa_fit_restarts(X, 3, jax.random.PRNGKey(9), n_init=8,
                            **kwargs)
    assert sharded['weights'].shape == (64, 3)
    assert np.allclose(np.asarray(sharded['costs']),
                       np.asarray(plain['costs']), rtol=1e-6)
    assert sharded['best_index'] == plain['best_index']


@pytest.mark.slow
def test_gpnh_mesh_with_restart_chunk():
    """GPNH chunking composed with mesh sharding: chunks are padded to
    the restart axis and pad restarts masked by the runtime n_valid."""
    from convex_dim_red_tpu.parallel.restarts import gpnh_fit_restarts
    rng = np.random.RandomState(24)
    X, _ = _planted(rng, n_samples=40)
    mesh = create_mesh(shape=(4,), axis_names=("restarts",),
                       devices=jax.devices()[:4])

    kwargs = dict(tolerance=1e-9, max_iterations=60, init='random',
                  mesh=mesh)
    full = gpnh_fit_restarts(X, 3, jax.random.PRNGKey(2), n_init=6,
                             **kwargs)
    chunked = gpnh_fit_restarts(X, 3, jax.random.PRNGKey(2), n_init=6,
                                restart_chunk=4, **kwargs)
    assert chunked['costs'].shape == (6,)
    assert np.allclose(chunked['costs'], full['costs'],
                       rtol=1e-2, atol=1e-10)
    assert chunked['best_index'] == full['best_index']


@pytest.mark.slow
def test_sharded_kmeans_matches_single_device():
    from convex_dim_red_tpu.models.kmeans import kmeans_fit
    from convex_dim_red_tpu.parallel.sharded_models import sharded_kmeans_fit

    rng = np.random.RandomState(7)
    X = np.concatenate([rng.standard_normal((16, 5)) + 4 * e
                        for e in np.eye(5)[:3]])  # 48 rows, 3 blobs
    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))
    key = jax.random.PRNGKey(0)

    res = sharded_kmeans_fit(mesh, jnp.asarray(X), key, n_clusters=3,
                             n_init=4, max_iter=100)
    c0, l0, inertia0, _ = kmeans_fit(jnp.asarray(X), key, n_clusters=3,
                                     n_init=4, max_iter=100)

    # Same restart keys, same math (categorical over the gathered
    # distance vector == the single-device draw): identical selection.
    assert float(res['inertia']) == pytest.approx(float(inertia0),
                                                  rel=1e-8)
    order = np.lexsort(np.asarray(res['centroids']).T)
    order0 = np.lexsort(np.asarray(c0).T)
    assert np.allclose(np.asarray(res['centroids'])[order],
                       np.asarray(c0)[order0], atol=1e-8)
    assert res['labels'].shape == (48,)
    assert res['inertias'].shape == (4,)
    assert float(res['inertia']) == pytest.approx(
        float(np.asarray(res['inertias']).min()), rel=1e-12)


@pytest.mark.slow
def test_sharded_kmeans_random_init():
    from convex_dim_red_tpu.models.kmeans import kmeans_fit
    from convex_dim_red_tpu.parallel.sharded_models import sharded_kmeans_fit

    rng = np.random.RandomState(8)
    X = rng.standard_normal((32, 4))
    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))
    key = jax.random.PRNGKey(3)

    res = sharded_kmeans_fit(mesh, jnp.asarray(X), key, n_clusters=2,
                             n_init=2, init='random', max_iter=50)
    _, _, inertia0, _ = kmeans_fit(jnp.asarray(X), key, n_clusters=2,
                                   n_init=2, init='random', max_iter=50)
    assert float(res['inertia']) == pytest.approx(float(inertia0),
                                                  rel=1e-8)
    # Inertia is consistent with the returned centroids/labels.
    C = np.asarray(res['centroids'])
    labels = np.asarray(res['labels'])
    recomputed = np.sum((X - C[labels]) ** 2)
    assert float(res['inertia']) == pytest.approx(recomputed, rel=1e-10)


def test_sharded_pca_matches_dense_svd():
    from convex_dim_red_tpu.parallel.sharded_models import sharded_pca

    rng = np.random.RandomState(9)
    X = rng.standard_normal((20, 64)) @ np.diag(
        np.linspace(3, 0.1, 64))
    mesh = create_mesh(shape=(8,), axis_names=("samples",))

    res = sharded_pca(mesh, jnp.asarray(X), n_components=4,
                      feature_axis="samples")
    Xc = X - X.mean(axis=0)
    U, S, Vh = np.linalg.svd(Xc, full_matrices=False)

    assert np.allclose(np.asarray(res['singular_values']), S[:4],
                       rtol=1e-9)
    assert np.allclose(np.asarray(res['explained_variance']),
                       S[:4] ** 2 / (20 - 1), rtol=1e-9)
    assert np.allclose(np.asarray(res['mean']), X.mean(axis=0),
                       atol=1e-12)
    # Components/scores match up to per-component sign.
    comps = np.asarray(res['components'])
    scores = np.asarray(res['scores'])
    for j in range(4):
        sign = np.sign(comps[j] @ Vh[j])
        assert np.allclose(sign * comps[j], Vh[j], atol=1e-8)
        assert np.allclose(sign * scores[:, j], U[:, j] * S[j],
                           atol=1e-8)
    # Reconstruction from the sharded factors.
    assert np.allclose(scores @ comps + np.asarray(res['mean']),
                       U[:, :4] * S[:4] @ Vh[:4] + X.mean(axis=0),
                       atol=1e-8)


@pytest.mark.slow
def test_sharded_gap_statistic_matches_single_device():
    from convex_dim_red_tpu.models.kmeans import gap_statistic
    from convex_dim_red_tpu.parallel.sharded_models import (
        sharded_gap_statistic)

    rng = np.random.RandomState(11)
    X = np.concatenate([rng.standard_normal((12, 4)) + 3 * e
                        for e in np.eye(4)[:2]])
    mesh = create_mesh(shape=(8,), axis_names=("restarts",))

    for reference in ('uniform', 'pca'):
        gap0, sk0 = gap_statistic(X, Wk=50.0, n_components=2,
                                  n_trials=16, reference=reference,
                                  random_state=0)
        gap, sk = sharded_gap_statistic(
            mesh, X, 50.0, 2, n_trials=16, reference=reference,
            random_state=0)
        # Same per-trial keys, trials distributed: identical statistics.
        assert gap == pytest.approx(gap0, rel=1e-10)
        assert sk == pytest.approx(sk0, rel=1e-10)


@pytest.mark.slow
def test_sharded_fits_pallas_weights_match_xla(monkeypatch):
    """backend='pallas' in the sharded fits routes the restart-batched
    weights QPs through the grouped fused kernel (interpret mode here)
    and converges to the same optimum as the XLA backend."""
    import convex_dim_red_tpu.parallel.sharded_aa as sa
    from convex_dim_red_tpu.solvers.spg import (
        quad_simplex_spg_batch_grouped)

    backends_seen = []

    def grouped_interpret(As, Bs, X0s, backend='xla', mask=None, **kw):
        backends_seen.append(backend)
        if backend == 'pallas':
            # The fused kernel in interpret mode on the CPU mesh.
            kw = dict(kw, interpret=True)
        return quad_simplex_spg_batch_grouped(As, Bs, X0s,
                                              backend=backend,
                                              mask=mask, **kw)

    monkeypatch.setattr(sa, 'quad_simplex_spg_batch_grouped',
                        grouped_interpret)
    # The pallas HLO INTERPRETER (CPU stand-in) trips check_vma on its
    # own internal block slicing — a JAX limitation with check_vma=False
    # as the suggested workaround; the compiled kernel and the XLA
    # backend keep the static check (sharded_aa.CHECK_VMA default).
    monkeypatch.setattr(sa, 'CHECK_VMA', False)

    rng = np.random.RandomState(13)
    n, k, R = 32, 3, 4
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=6)
    Zs = rng.uniform(size=(R, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(R, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    alphas = np.ones((R, k))
    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))

    kw = dict(tolerance=1e-10, max_iterations=120)
    res_p = sa.sharded_aa_fit(
        mesh, jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas),
        weights_solver_kwargs={'backend': 'pallas'}, **kw)
    res_x = sa.sharded_aa_fit(
        mesh, jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas), **kw)

    assert 'pallas' in backends_seen
    # Different inner solvers (fused early-exit vs lockstep) -> same
    # optimum on planted data, compared at the convergence floor.
    assert float(res_p['cost']) < 1e-6
    assert abs(float(res_p['cost']) - float(res_x['cost'])) < 1e-6
    assert np.allclose(np.asarray(res_p['weights']).sum(axis=1), 1.0,
                       atol=1e-6)

    # GPNH analog.
    Ws = rng.standard_normal((R, 6, k))
    gres_p = sa.sharded_gpnh_fit(
        mesh, jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Ws),
        lambda_W=1e-3, weights_solver_kwargs={'backend': 'pallas'},
        **kw)
    gres_x = sa.sharded_gpnh_fit(
        mesh, jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Ws),
        lambda_W=1e-3, **kw)
    assert abs(float(gres_p['cost']) - float(gres_x['cost'])) < 1e-6


@pytest.mark.slow
def test_sharded_kernel_aa_fit_matches_data_space():
    from convex_dim_red_tpu.parallel.sharded_aa import (
        sharded_aa_fit, sharded_kernel_aa_fit)

    rng = np.random.RandomState(12)
    n, k, R = 32, 3, 4
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=6)
    K = X @ X.T
    Zs = rng.uniform(size=(R, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(R, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    alphas = np.ones((R, k))
    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))

    res_k = sharded_kernel_aa_fit(
        mesh, jnp.asarray(K), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas), tolerance=1e-10, max_iterations=150)
    res_d = sharded_aa_fit(
        mesh, jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas), tolerance=1e-10, max_iterations=150)

    # Identical updates; only the cost form differs (trace vs explicit
    # residual), so trajectories agree to float64 cancellation noise.
    assert np.allclose(np.asarray(res_k['costs']),
                       np.asarray(res_d['costs']), atol=1e-8)
    assert float(res_k['cost']) < 1e-6
    assert np.allclose(np.asarray(res_k['weights']).sum(axis=1), 1,
                       atol=1e-10)
    assert np.allclose(np.asarray(res_k['dictionary']).sum(axis=1), 1,
                       atol=1e-10)

    # delta != 0: the scale-factor update stays in its box.
    res_s = sharded_kernel_aa_fit(
        mesh, jnp.asarray(K), jnp.asarray(Zs), jnp.asarray(Cs),
        jnp.asarray(alphas), delta=0.1, tolerance=1e-10,
        max_iterations=50)
    a = np.asarray(res_s['alpha'])
    assert (a >= 0.9 - 1e-12).all() and (a <= 1.1 + 1e-12).all()


@pytest.mark.slow
def test_sharded_train_step_pallas_backend_matches_xla(monkeypatch):
    """weights_backend='pallas' on sharded_aa_train_step routes the
    restart-batched weight QPs through the grouped fused kernel and
    reproduces the XLA backend's step (unique QP optima => same
    result)."""
    import convex_dim_red_tpu.parallel.sharded_aa as sa
    from convex_dim_red_tpu.solvers.spg import (
        quad_simplex_spg_batch_grouped)

    backends_seen = []

    def grouped_interpret(As, Bs, X0s, backend='xla', mask=None, **kw):
        backends_seen.append(backend)
        if backend == 'pallas':
            # The fused kernel in interpret mode on the CPU mesh.
            kw = dict(kw, interpret=True)
        return quad_simplex_spg_batch_grouped(As, Bs, X0s,
                                              backend=backend,
                                              mask=mask, **kw)

    monkeypatch.setattr(sa, 'quad_simplex_spg_batch_grouped',
                        grouped_interpret)
    # The pallas HLO INTERPRETER (CPU stand-in) trips check_vma on its
    # own internal block slicing — a JAX limitation with check_vma=False
    # as the suggested workaround; the compiled kernel and the XLA
    # backend keep the static check (sharded_aa.CHECK_VMA default).
    monkeypatch.setattr(sa, 'CHECK_VMA', False)

    rng = np.random.RandomState(17)
    n, k, R = 16, 2, 4
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=5)
    Zs = rng.uniform(size=(R, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(R, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    alphas = np.ones((R, k))
    mesh = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))

    args = (jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
            jnp.asarray(alphas))
    kw = dict(dict_iterations=3, weights_iterations=200)
    Zp, Cp, ap, costs_p = sa.sharded_aa_train_step(
        mesh, *args, weights_backend='pallas', **kw)
    Zx, Cx, ax, costs_x = sa.sharded_aa_train_step(mesh, *args, **kw)

    assert 'pallas' in backends_seen
    # Same scale/dictionary math; the weight QPs are strictly convex,
    # so both inner solvers land on the same unique optimum.
    assert np.allclose(np.asarray(Cp), np.asarray(Cx), atol=1e-10)
    assert np.allclose(np.asarray(Zp), np.asarray(Zx), atol=1e-6)
    assert np.allclose(np.asarray(costs_p), np.asarray(costs_x),
                       atol=1e-8)
    assert np.allclose(np.asarray(Zp).sum(axis=2), 1.0, atol=1e-8)


def test_create_mesh_layout():
    """create_mesh lays devices out row-major over the named axes; with
    ``shape=None`` every device goes on the first axis."""
    devices = jax.devices()
    mesh = create_mesh(shape=(2, 4))
    assert mesh.axis_names == ("restarts", "samples")
    assert mesh.devices.shape == (2, 4)
    for r in range(2):
        assert list(mesh.devices[r]) == list(devices[4 * r:4 * r + 4])

    flat = create_mesh()
    assert flat.devices.shape == (8, 1)
    assert list(flat.devices[:, 0]) == list(devices)

    # An explicit device list sets the order; a shape that does not
    # match the device count fails at construction.
    rev = create_mesh(shape=(1, 4), devices=devices[4:][::-1])
    assert list(rev.devices[0]) == list(devices[4:][::-1])
    with pytest.raises(ValueError):
        create_mesh(shape=(3, 3))


@pytest.mark.slow
def test_sharded_aa_fit_invariant_to_mesh_device_order():
    """The SPMD fit must be numerically invariant to the order of the
    devices in its mesh."""
    from convex_dim_red_tpu.parallel.sharded_aa import sharded_aa_fit

    rng = np.random.RandomState(11)
    n, k, R = 32, 3, 4
    X, _ = _planted(rng, n_samples=n, n_components=k, n_features=6)
    Zs, Cs = _random_aa_state(rng, R, n, k)
    alphas = np.ones((R, k))

    devices = jax.devices()
    # Reversed device order: a genuinely different layout than the flat
    # mesh, so agreement shows layout invariance rather than identity.
    reordered = create_mesh(shape=(2, 4), devices=devices[::-1])
    flat = create_mesh(shape=(2, 4), axis_names=("restarts", "samples"))
    assert not np.array_equal(np.asarray(reordered.devices),
                              np.asarray(flat.devices))

    kwargs = dict(tolerance=1e-10, max_iterations=40,
                  stopping_criterion='abs_delta_f')
    res_h = sharded_aa_fit(reordered, jnp.asarray(X), jnp.asarray(Zs),
                           jnp.asarray(Cs), jnp.asarray(alphas), **kwargs)
    res_f = sharded_aa_fit(flat, jnp.asarray(X), jnp.asarray(Zs),
                           jnp.asarray(Cs), jnp.asarray(alphas), **kwargs)
    assert np.allclose(np.asarray(res_h['costs']),
                       np.asarray(res_f['costs']), rtol=1e-10, atol=1e-12)
    assert np.array_equal(np.asarray(res_h['n_iters']),
                          np.asarray(res_f['n_iters']))
