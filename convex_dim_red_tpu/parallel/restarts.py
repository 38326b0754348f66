"""Multi-restart fits: vmapped on one chip, shard_map'd over a mesh.

The reference's keep-best-of-``n_init`` loop is serial Python
(reference bin/run_hadisst_aa.py:149-174, n_init=100) — the single
biggest win in this workload.  Here the restart axis is a ``vmap``
batch of PRNG keys: every alternating update's matmuls gain a leading
restart dimension (bigger matmul tiles), and the lockstep while loop runs
until the slowest restart converges.  On a mesh the same batch runs
under ``shard_map`` over the ``restarts`` axis — partitioning is
structural (each device group sees only its local keys; there is no
reliance on XLA auto-sharding), trip counts are independent per group,
and the keep-best reduction is an ``all_gather``-argmin +
``psum``-broadcast of the winning state (parallel/sharded_aa.py
``_select_best``).

The jitted runners are built once per static configuration
(``functools.lru_cache``) so repeated calls — restart chunks, sweep
points, benchmark repetitions — reuse the traced program instead of
re-tracing on every call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..models._common import QPSolverConfig, SPGSolverConfig, make_config
from ..models.archetypal_analysis import (_cost_from_parts,
                                          _kernel_aa_core, _scalar_dtype,
                                          _spg_cfg_to_quad_kwargs)
from ..ops.furthest_sum import furthest_sum_device, \
    dissimilarities_from_kernel
from ..ops.simplex_projection import simplex_project_rows
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..solvers.spg import (quad_spg, quad_simplex_spg_batch_grouped,
                           resolve_qp_backend)
from ..utils.precision import apply_matmul_precision
from . import sharded_aa as _sharded_aa
from .sharded_aa import _keep_best_loop, _select_best

__all__ = ["aa_fit_restarts", "kernel_aa_fit_restarts",
           "gpnh_fit_restarts", "select_best"]


def select_best(costs, state):
    """Select the argmin-cost slice of a stacked result pytree."""
    best = jnp.argmin(costs)
    return jax.tree_util.tree_map(lambda leaf: leaf[best], state)


def _padded_components(n_components, pad_components_to):
    """Resolve the padded component count and its runtime mask.

    When ``pad_components_to == n_components`` the mask is all-true
    rather than ``None``: the masked program is exact for a full mask
    (tests/test_padded_components.py), and returning ``None`` would
    compile a *separate* maskless program for exact-multiple ``k``
    values — defeating the bucketing goal for them (each extra
    protocol-scale program pays its own compilation)."""
    if pad_components_to is None or int(pad_components_to) < n_components:
        return n_components, None
    k_pad = int(pad_components_to)
    return k_pad, jnp.arange(k_pad) < n_components


def _pad_keys(keys, axis_size):
    """Pad the key batch to a multiple of the mesh restart axis; padded
    restarts run but are masked out of the keep-best selection.  The
    pad can exceed the batch size (e.g. 3 restarts on an 8-device
    restart axis), so the batch is tiled, not sliced."""
    n = keys.shape[0]
    pad = (-n) % axis_size
    if pad:
        reps = -(-(n + pad) // n)
        keys = jnp.tile(keys, (reps, 1))[:n + pad]
    return keys, n


# ---------------------------------------------------------------------------
# Archetypal analysis
# ---------------------------------------------------------------------------



def _prepare_aa_inputs(X, has_data, init):
    """Shared runner setup: Gram (or passthrough kernel), dissimilarity
    matrix for FurthestSum inits, and the data operand for the
    residual-form cost."""
    K = X @ X.T if has_data else X
    diss = (dissimilarities_from_kernel(K)
            if init == 'furthest_sum' else None)
    data = X if has_data else jnp.zeros((), K.dtype)
    return K, diss, data


def _init_aa_state(key, delta, *, n_samples, n_components, init, diss,
                   n_extra_steps, component_mask, do_scale, dtype):
    """One restart's (Z, C, alpha) initialization (reference init
    dispatch, archetypal_analysis.py:151-164 + alpha init :73-81),
    shared by the vmapped and grouped restart batches so both paths see
    bit-identical starting states for the same key."""
    k_start, k_dict, k_weights, k_alpha = jax.random.split(key, 4)
    if init == 'furthest_sum':
        start = jax.random.randint(k_start, (), 0, n_samples)
        selected = furthest_sum_device(
            diss, n_components, start, extra_steps=n_extra_steps)
        C = jax.nn.one_hot(selected, n_samples, dtype=dtype)
    else:
        C = right_stochastic_matrix(
            k_dict, (n_components, n_samples), dtype=dtype)
    if component_mask is None:
        Z = right_stochastic_matrix(
            k_weights, (n_samples, n_components), dtype=dtype)
    else:
        u = jax.random.uniform(
            k_weights, (n_samples, n_components), dtype=dtype)
        u = u * component_mask.astype(dtype)
        Z = u / jnp.sum(u, axis=1, keepdims=True)
    if do_scale:
        alpha = jax.random.uniform(
            k_alpha, (n_components,), dtype=dtype,
            minval=1 - delta, maxval=1 + delta)
    else:
        alpha = jnp.ones((n_components,), dtype=dtype)
    return Z, C, alpha


def _aa_fit_batch(X, K, diss, keys, delta, tolerance, component_mask,
                  *, n_components, init, max_iterations, n_extra_steps,
                  criterion, do_scale, has_data, dict_cfg, weights_cfg,
                  scale_cfg):
    """Vmapped batch of independent kernel-AA fits (stacked outputs).

    ``component_mask`` (runtime (n_components,) bool or None) runs
    padded-``k`` fits: masked-out components get zero initial weight
    and are pinned at zero by the masked weights QP, so each fit is
    exactly a ``sum(mask)``-component model (padded dictionary rows are
    frozen — zero gradient; see ``_kernel_aa_core``).  The mask being a
    runtime value is the point: one compiled program per *bucket* of
    component counts instead of one per ``k``.
    """
    n_samples = K.shape[0]
    dtype = K.dtype

    def fit_one(key):
        Z, C, alpha = _init_aa_state(
            key, delta, n_samples=n_samples, n_components=n_components,
            init=init, diss=diss, n_extra_steps=n_extra_steps,
            component_mask=component_mask, do_scale=do_scale,
            dtype=dtype)

        Z, C, alpha, cost, n_iter, trace, _, _ = _kernel_aa_core(
            K, Z, C, alpha, delta, tolerance, X, component_mask,
            do_scale=do_scale, do_dict=True, do_weights=True,
            criterion=criterion, max_iterations=max_iterations,
            require_monotonic=False, has_data=has_data,
            dict_cfg=dict_cfg, weights_cfg=weights_cfg,
            scale_cfg=scale_cfg)
        return Z, C, alpha, cost, n_iter, trace

    return jax.vmap(fit_one)(keys)


@functools.lru_cache(maxsize=128)
def _make_aa_run(mesh, restart_axis, *, n_components, init,
                 max_iterations, n_extra_steps, criterion, do_scale,
                 has_data, dict_cfg, weights_cfg, scale_cfg):
    """Build the jitted keep-best runner for one static configuration.

    Returns a function ``(X_or_K, keys, delta, tolerance,
    component_mask, n_valid) -> (Z, C, alpha, trace, costs, n_iters,
    best_cost, best_n_iter)`` where the first six describe the best
    restart / all restarts.  ``n_valid`` is a *runtime* scalar masking
    tiled pad restarts out of the keep-best selection — runtime so a
    final partial chunk padded to the same shape reuses the compiled
    program instead of recompiling (the pad count would otherwise be
    baked into the cache key).  With ``mesh`` given, the key batch is
    shard_map'd over ``restart_axis``; every device group runs only its
    local restarts (structural partitioning) and the winner is selected
    across the mesh.
    """
    statics = dict(n_components=n_components, init=init,
                   max_iterations=max_iterations,
                   n_extra_steps=n_extra_steps, criterion=criterion,
                   do_scale=do_scale, has_data=has_data,
                   dict_cfg=dict_cfg, weights_cfg=weights_cfg,
                   scale_cfg=scale_cfg)

    def prepare(X):
        # ArchetypalAnalysis path: X is data, Gram formed on device;
        # KernelAA path: X *is* the kernel.
        return _prepare_aa_inputs(X, has_data, init)

    def local_best(Zs, Cs, alphas, costs, n_iters, traces, n_valid):
        masked = jnp.where(jnp.arange(costs.shape[0]) < n_valid,
                           costs, jnp.inf)
        best = jnp.argmin(masked)
        return (Zs[best], Cs[best], alphas[best], traces[best],
                costs, n_iters, costs[best], n_iters[best])

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, keys, delta, tolerance, component_mask, n_valid):
            K, diss, data = prepare(X)
            out = _aa_fit_batch(data, K, diss, keys, delta, tolerance,
                                component_mask, **statics)
            return local_best(*out, n_valid)
        return run

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, delta, tolerance, component_mask, n_valid):
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(restart_axis, None), P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P(),
                       P(restart_axis), P(restart_axis), P(), P()),
            check_vma=_sharded_aa.CHECK_VMA)
        def shard_fit(X, keys_loc, delta, tolerance, component_mask,
                      n_valid):
            K, diss, data = prepare(X)
            Zs, Cs, alphas, costs, n_iters, traces = _aa_fit_batch(
                data, K, diss, keys_loc, delta, tolerance,
                component_mask, **statics)
            best, best_cost, best_n_iter, best_trace = _select_best(
                (Zs, Cs, alphas), costs, traces, n_iters,
                n_valid=n_valid, restart_axis=restart_axis)
            Z, C, alpha = best
            return (Z, C, alpha, best_trace, costs, n_iters,
                    best_cost, best_n_iter)

        return shard_fit(X, keys, delta, tolerance, component_mask,
                         n_valid)

    return run


# ---------------------------------------------------------------------------
# Grouped single-chip runners: weights QP batched ACROSS restarts
# ---------------------------------------------------------------------------


def _aa_grouped_iterate(X, K, *, delta, do_scale, has_data, dict_kwargs,
                        weights_backend, weights_kwargs, scale_kwargs,
                        component_mask, trace_K):
    """Restart-batched AA alternating iterate with the weights QP
    grouped across restarts.

    Single-device analog of ``sharded_aa._aa_iterate_batch`` (collectives
    replaced by plain contractions): the scale/dictionary updates vmap
    over restarts, and the weights QP dispatches through
    :func:`solvers.spg.quad_simplex_spg_batch_grouped`, so
    ``weights_backend='pallas'`` solves ALL restarts' row QPs in one
    fused grouped kernel (ops/pallas_qp.py) — each row runs to its own
    fixed point instead of the vmapped path's chunk-lockstep (see
    ``solvers.spg.resolve_qp_backend`` for the measured numbers).
    Per-iteration math matches
    ``models.archetypal_analysis._kernel_aa_core`` term by term
    (reference update order: scale -> dictionary -> weights,
    archetypal_analysis.py:399-531).

    Returns ``(iterate, cost0)``: ``iterate(Zs, Cs, alphas) -> (Zs, Cs,
    alphas, costs)`` for :func:`sharded_aa._keep_best_loop`, and
    ``cost0(Zs, Cs, alphas)`` evaluating the initial objective.
    """
    n_samples = K.shape[0]
    sdt = _scalar_dtype(K.dtype)

    def pre(Z, C, alpha):
        ZtZ = Z.T @ Z
        KZ = K @ Z
        if do_scale:
            CK0 = C @ K
            CKZ = CK0 @ Z
            CKCt0 = CK0 @ C.T
            M = ZtZ * CKCt0
            project = lambda a: jnp.clip(a, 1.0 - delta, 1.0 + delta)
            alpha = quad_spg(lambda a: (M @ a) / n_samples,
                             jnp.diagonal(CKZ) / n_samples, alpha,
                             project, **scale_kwargs)
        KZD = KZ * alpha[None, :]
        DZtZD = (alpha[:, None] * ZtZ) * alpha[None, :]
        C = quad_spg(lambda Cm: DZtZD @ (Cm @ K) / n_samples,
                     KZD.T / n_samples, C, simplex_project_rows,
                     **dict_kwargs)
        CK = C @ K
        CKCt = CK @ C.T
        A = (alpha[:, None] * CKCt) * alpha[None, :]
        Bw = -(alpha[:, None] * CK).T
        return C, alpha, A, Bw, CK, CKCt

    def cost_of(Z, C, alpha, CK, CKCt):
        if has_data:
            # Residual form: reliable in float32 (no trace cancellation;
            # see _kernel_aa_core docstring).
            CX = C @ X
            resid = Z @ (alpha[:, None] * CX) - X
            return (0.5 * jnp.sum(resid * resid) / n_samples).astype(sdt)
        CKZ = CK @ Z
        ZtZ = Z.T @ Z
        return _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples)

    def iterate(Zs, Cs, alphas):
        Cs, alphas, As, Bws, CKs, CKCts = jax.vmap(pre)(Zs, Cs, alphas)
        Zs = quad_simplex_spg_batch_grouped(
            As, Bws, Zs, backend=weights_backend, mask=component_mask,
            **weights_kwargs)
        costs = jax.vmap(cost_of)(Zs, Cs, alphas, CKs, CKCts)
        return Zs, Cs, alphas, costs

    def cost0(Zs, Cs, alphas):
        def one(Z, C, alpha):
            CK = C @ K
            return cost_of(Z, C, alpha, CK, CK @ C.T)
        return jax.vmap(one)(Zs, Cs, alphas)

    return iterate, cost0


def _grouped_solver_kwargs(dict_cfg, weights_cfg, scale_cfg):
    return (_spg_cfg_to_quad_kwargs(dict_cfg), weights_cfg.kwargs(),
            _spg_cfg_to_quad_kwargs(scale_cfg))


def _prepare_grouped(X, has_data, init, K=None):
    """Runner setup with an optional PRECOMPUTED Gram: the compaction
    scheduler calls a round runner rounds*chunks times per fit, and
    re-deriving ``K = X X'`` inside each jitted call would pay ~100
    GFLOP per call at protocol shape — so it computes the Gram once
    per fit and passes it in device-resident."""
    if K is None:
        K, diss, data = _prepare_aa_inputs(X, has_data, init)
    else:
        diss = (dissimilarities_from_kernel(K)
                if init == 'furthest_sum' else None)
        data = X if has_data else jnp.zeros((), K.dtype)
    sdt = _scalar_dtype(K.dtype)
    trace_K = None if has_data else jnp.trace(K, dtype=sdt)
    return K, diss, data, trace_K


#: One-per-fit Gram for the compaction scheduler, compiled under the
#: same matmul-precision policy as the round runners.
_gram_once = apply_matmul_precision(jax.jit(lambda x: x @ x.T))


@functools.lru_cache(maxsize=128)
def _make_aa_grouped_run(*, n_components, init, max_iterations,
                         n_extra_steps, criterion, do_scale, has_data,
                         dict_cfg, weights_cfg, scale_cfg,
                         weights_backend):
    """Grouped analog of ``_make_aa_run(mesh=None)`` — same call
    signature and return tuple, but the restart batch advances through
    :func:`_aa_grouped_iterate` under ``sharded_aa._keep_best_loop``
    (per-restart freezing) instead of vmapping whole ``_kernel_aa_core``
    fits.  This is the production single-chip protocol path on the GPU,
    with the fused weights kernel (see ``resolve_qp_backend``)."""
    dict_kwargs, weights_kwargs, scale_kwargs = _grouped_solver_kwargs(
        dict_cfg, weights_cfg, scale_cfg)

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, delta, tolerance, component_mask, n_valid):
        K, diss, data, trace_K = _prepare_grouped(X, has_data, init)
        Zs, Cs, alphas = jax.vmap(functools.partial(
            _init_aa_state, n_samples=K.shape[0],
            n_components=n_components, init=init, diss=diss,
            n_extra_steps=n_extra_steps, component_mask=component_mask,
            do_scale=do_scale, dtype=K.dtype), in_axes=(0, None))(
                keys, delta)
        iterate, cost0 = _aa_grouped_iterate(
            data, K, delta=delta, do_scale=do_scale, has_data=has_data,
            dict_kwargs=dict_kwargs, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
            component_mask=component_mask, trace_K=trace_K)
        states, costs, trace, n_iters, _ = _keep_best_loop(
            (Zs, Cs, alphas), cost0(Zs, Cs, alphas), iterate,
            tolerance=tolerance, criterion=criterion,
            max_iterations=max_iterations)
        Zs, Cs, alphas = states
        masked = jnp.where(jnp.arange(costs.shape[0]) < n_valid,
                           costs, jnp.inf)
        best = jnp.argmin(masked)
        return (Zs[best], Cs[best], alphas[best], trace[best],
                costs, n_iters, costs[best], n_iters[best])

    return run


@functools.lru_cache(maxsize=128)
def _make_aa_grouped_screen_run(*, n_components, init, max_iterations,
                                n_extra_steps, criterion, do_scale,
                                has_data, dict_cfg, weights_cfg,
                                scale_cfg, weights_backend):
    """Grouped analog of ``_make_aa_screen_run(mesh=None)``: every
    restart's state after a bounded screening pass, stacked."""
    dict_kwargs, weights_kwargs, scale_kwargs = _grouped_solver_kwargs(
        dict_cfg, weights_cfg, scale_cfg)

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, delta, tolerance, component_mask=None):
        K, diss, data, trace_K = _prepare_grouped(X, has_data, init)
        Zs, Cs, alphas = jax.vmap(functools.partial(
            _init_aa_state, n_samples=K.shape[0],
            n_components=n_components, init=init, diss=diss,
            n_extra_steps=n_extra_steps, component_mask=component_mask,
            do_scale=do_scale, dtype=K.dtype), in_axes=(0, None))(
                keys, delta)
        iterate, cost0 = _aa_grouped_iterate(
            data, K, delta=delta, do_scale=do_scale, has_data=has_data,
            dict_kwargs=dict_kwargs, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
            component_mask=component_mask, trace_K=trace_K)
        states, costs, _, n_iters, _ = _keep_best_loop(
            (Zs, Cs, alphas), cost0(Zs, Cs, alphas), iterate,
            tolerance=tolerance, criterion=criterion,
            max_iterations=max_iterations)
        Zs, Cs, alphas = states
        return Zs, Cs, alphas, costs, n_iters

    return run


@functools.lru_cache(maxsize=128)
def _make_aa_grouped_resume_run(*, max_iterations, criterion, do_scale,
                                has_data, dict_cfg, weights_cfg,
                                scale_cfg, weights_backend):
    """Grouped analog of ``_make_aa_resume_run(mesh=None)``: continue a
    batch of fits from explicit states, then keep the best."""
    dict_kwargs, weights_kwargs, scale_kwargs = _grouped_solver_kwargs(
        dict_cfg, weights_cfg, scale_cfg)

    @apply_matmul_precision
    @jax.jit
    def run(X, Zs, Cs, alphas, delta, tolerance, component_mask=None,
            n_valid=None):
        K, _, data, trace_K = _prepare_grouped(X, has_data, init=None)
        iterate, cost0 = _aa_grouped_iterate(
            data, K, delta=delta, do_scale=do_scale, has_data=has_data,
            dict_kwargs=dict_kwargs, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
            component_mask=component_mask, trace_K=trace_K)
        states, costs, trace, n_iters, _ = _keep_best_loop(
            (Zs, Cs, alphas), cost0(Zs, Cs, alphas), iterate,
            tolerance=tolerance, criterion=criterion,
            max_iterations=max_iterations)
        Zs, Cs, alphas = states
        best = jnp.argmin(costs)
        return (Zs[best], Cs[best], alphas[best], trace[best],
                costs, n_iters, costs[best], n_iters[best])

    return run


@functools.lru_cache(maxsize=128)
def _make_aa_grouped_round_run(*, fresh, max_iterations, criterion,
                               do_scale, has_data, dict_cfg, weights_cfg,
                               scale_cfg, weights_backend,
                               n_components=None, init=None,
                               n_extra_steps=None, mesh=None,
                               restart_axis=None):
    """One bounded, DEVICE-RESIDENT compaction round of grouped restarts.

    The restart population's states live in fixed-width ``(R, ...)``
    device arrays for the whole compacted fit; each round call GATHERS
    its chunk by an ``idx`` vector inside the jitted program, advances
    it up to ``max_iterations`` iterations, and SCATTERS the resulting
    states back into the population arrays — so between rounds no state
    ever crosses the host boundary.  Only the per-chunk scalars the
    scheduler needs —
    costs, cost-delta trace, iteration counts, converged mask — are
    fetched, in one ``device_get`` per chunk.

    ``fresh=True`` initializes the chunk from ``keys_all[idx]``;
    ``fresh=False`` resumes from ``states_all`` gathered at ``idx``.
    Duplicate indices (tail-chunk tiling) are harmless: duplicated rows
    compute identical trajectories, so the scatter writes equal values.
    """
    dict_kwargs, weights_kwargs, scale_kwargs = _grouped_solver_kwargs(
        dict_cfg, weights_cfg, scale_cfg)

    def finish(K, data, trace_K, states_all, idx, Zs, Cs, alphas,
               tolerance, component_mask, delta, write_mask):
        iterate, cost0 = _aa_grouped_iterate(
            data, K, delta=delta, do_scale=do_scale, has_data=has_data,
            dict_kwargs=dict_kwargs, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
            component_mask=component_mask, trace_K=trace_K)
        states, costs, trace, n_iters, done = _keep_best_loop(
            (Zs, Cs, alphas), cost0(Zs, Cs, alphas), iterate,
            tolerance=tolerance, criterion=criterion,
            max_iterations=max_iterations)
        Zs, Cs, alphas = states
        Z_all, C_all, a_all = states_all
        # ``write_mask`` guards the scatter: rows a mesh group ran only
        # to stay in lockstep (dummy rows of an already-drained group)
        # must not advance their retired population state.
        Zs = jnp.where(write_mask[:, None, None], Zs, Z_all[idx])
        Cs = jnp.where(write_mask[:, None, None], Cs, C_all[idx])
        alphas = jnp.where(write_mask[:, None], alphas, a_all[idx])
        Z_all = Z_all.at[idx].set(Zs)
        C_all = C_all.at[idx].set(Cs)
        a_all = a_all.at[idx].set(alphas)
        return (Z_all, C_all, a_all), costs, trace, n_iters, done

    def round_local(X, gram, keys_all, states_all, idx, write_mask,
                    delta, tolerance, component_mask):
        if fresh:
            K, diss, data, trace_K = _prepare_grouped(X, has_data, init,
                                                      K=gram)
            Zs, Cs, alphas = jax.vmap(functools.partial(
                _init_aa_state, n_samples=K.shape[0],
                n_components=n_components, init=init, diss=diss,
                n_extra_steps=n_extra_steps,
                component_mask=component_mask,
                do_scale=do_scale, dtype=K.dtype), in_axes=(0, None))(
                    keys_all[idx], delta)
        else:
            K, diss, data, trace_K = _prepare_grouped(X, has_data, None,
                                                      K=gram)
            Z_all, C_all, a_all = states_all
            Zs, Cs, alphas = Z_all[idx], C_all[idx], a_all[idx]
        return finish(K, data, trace_K, states_all, idx, Zs, Cs,
                      alphas, tolerance, component_mask, delta,
                      write_mask)

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, gram, keys_all, states_all, idx, write_mask, delta,
                tolerance, component_mask=None):
            return round_local(X, gram, keys_all, states_all, idx,
                               write_mask, delta, tolerance,
                               component_mask)
        return run

    # Mesh path (per-group compaction): the population arrays shard
    # over ``restart_axis``; each restart group gathers ITS local chunk
    # (one row of the (n_groups, chunk) local-index array), advances it,
    # and scatters back — no cross-group collectives, so group trip
    # counts stay independent inside the round program.
    state_specs = (P(restart_axis, None, None),
                   P(restart_axis, None, None),
                   P(restart_axis, None))

    @apply_matmul_precision
    @jax.jit
    def run(X, gram, keys_all, states_all, idx, write_mask, delta,
            tolerance, component_mask=None):
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(), P(restart_axis, None), state_specs,
                      P(restart_axis, None), P(restart_axis, None),
                      P(), P(), P()),
            out_specs=(state_specs,
                       P(restart_axis, None),
                       P(restart_axis, None, None),
                       P(restart_axis, None),
                       P(restart_axis, None)),
            check_vma=_sharded_aa.CHECK_VMA)
        def shard_round(X, gram, keys_loc, states_loc, idx_loc, wm_loc,
                        delta, tolerance, component_mask):
            states_loc, cs, tr, ni, done = round_local(
                X, gram, keys_loc, states_loc, idx_loc[0], wm_loc[0],
                delta, tolerance, component_mask)
            return (states_loc, cs[None], tr[None], ni[None],
                    done[None])

        return shard_round(X, gram, keys_all, states_all, idx,
                           write_mask, delta, tolerance, component_mask)

    return run


def _compacted_best(R, states_all, *, max_iterations, restart_chunk,
                    round_iterations, make_round_call, n_groups=1,
                    n_valid=None):
    """Generic convergence-compaction scheduler over restart populations.

    The lockstep restart batch pays for its slowest member: at the
    HadISST protocol the per-chunk max iteration count is a multiple of
    the mean, so a fixed
    chunk burns most of its wall time advancing already-converged
    restarts.  Screening (``screen_iterations``) cuts that by pruning
    on cost — a heuristic.  Compaction cuts it EXACTLY: restarts run in
    bounded rounds of ``round_iterations``; after each round, converged
    restarts retire with their final state and the survivors are
    RE-PACKED into dense chunks for the next round, so batch width
    tracks the population that still needs work.  Each restart's
    trajectory is the same state-resuming chain the single-call fit
    executes (the carried ``done`` flag distinguishes convergence from
    the round cap), so results match the unchunked protocol restart for
    restart — this is a scheduling change, not a model change.

    ``make_round_call(fresh, M_round)`` returns a callable
    ``call(states_all, idx, write_mask) -> (states_all, costs, trace,
    n_iters, done)`` running one bounded round on the gathered chunk (a
    jitted gather/advance/scatter program; see
    :func:`_make_aa_grouped_round_run`).  ``idx``/``write_mask`` are
    ``(n_groups, chunk)`` GROUP-LOCAL index / valid-row arrays; returned
    scalars may come back flat or group-stacked (reshaped here).
    ``states_all`` is the pytree of fixed-width population arrays; all
    state stays on device — the host sees only per-chunk scheduler
    scalars.  The round programs are keyed by round length alone, so
    every round of a fit — and every fit in a process — reuses at most
    two compiled programs (full rounds + one clipped final round).

    ``n_groups > 1`` runs PER-GROUP compaction over a mesh restart
    axis: the population partitions into ``n_groups`` contiguous blocks
    of ``R // n_groups`` restarts (the shard_map sharding), each group
    compacts its own pending queue, and every dispatch advances one
    chunk per group in lockstep (a drained group re-runs dummy rows
    with ``write_mask=False`` so its retired states stay untouched).
    No collectives cross groups, so per-restart trajectories are
    identical to the single-chip schedule.  ``n_valid`` masks
    mesh-divisibility pad restarts out of scheduling and selection.

    Returns ``(states_all, costs, n_iters, traces, best)`` with
    ``best`` the argmin-cost restart index and ``traces[i]`` the
    per-restart concatenable cost-delta segments.
    """
    n_valid = R if n_valid is None else int(n_valid)
    R_loc = R // n_groups
    chunk = min(int(restart_chunk or R_loc), R_loc)
    M = int(round_iterations)

    costs = np.full((R,), np.inf)
    n_iters = np.zeros((R,), np.int64)
    traces = [[] for _ in range(R)]

    pending = [[i for i in range(g * R_loc, (g + 1) * R_loc)
                if i < n_valid] for g in range(n_groups)]
    used = 0
    while any(pending) and used < max_iterations:
        M_round = min(M, max_iterations - used)
        call = make_round_call(used == 0, M_round)

        # Dispatch every chunk of the round before fetching any result:
        # the calls are async, so device work and host latency overlap.
        waves = max(-(-len(p) // chunk) for p in pending if p)
        outs = []
        for w in range(waves):
            idx_np = np.zeros((n_groups, chunk), np.int64)
            wm_np = np.zeros((n_groups, chunk), bool)
            for g in range(n_groups):
                pg = pending[g][w * chunk:(w + 1) * chunk]
                if pg:
                    # Tile the tail so every round reuses the one
                    # compiled chunk width; duplicate rows recompute
                    # the same trajectory and are skipped below.
                    idx_np[g] = np.resize(np.asarray(pg), chunk)
                    wm_np[g] = True
                else:
                    idx_np[g] = g * R_loc  # dummy rows, writes masked
            idx_loc = jnp.asarray(idx_np - (np.arange(n_groups)
                                            * R_loc)[:, None], jnp.int32)
            states_all, cs, tr, ni, done = call(
                states_all, idx_loc, jnp.asarray(wm_np))
            outs.append((idx_np, wm_np, (cs, tr, ni, done)))

        next_pending = [[] for _ in range(n_groups)]
        for idx_np, wm_np, out in outs:
            cs, tr, ni, done = jax.device_get(out)
            cs = np.asarray(cs).reshape(n_groups, chunk)
            ni = np.asarray(ni).reshape(n_groups, chunk)
            done = np.asarray(done).reshape(n_groups, chunk)
            tr = np.asarray(tr).reshape(n_groups, chunk, -1)
            for g in range(n_groups):
                seen = set()
                for j, i in enumerate(idx_np[g]):
                    if not wm_np[g, j] or i in seen:
                        continue
                    seen.add(i)
                    n_iters[i] += ni[g, j]
                    traces[i].append(tr[g, j, :ni[g, j]])
                    if done[g, j] or used + M_round >= max_iterations:
                        costs[i] = cs[g, j]
                    else:
                        next_pending[g].append(i)
        pending = next_pending
        used += M_round

    best = int(np.argmin(costs))
    return states_all, costs, n_iters, traces, best


def _compacted_aa_best(X, keys, delta, tolerance, component_mask, *,
                       statics, grouped_backend, restart_chunk,
                       round_iterations, mesh=None,
                       restart_axis='restarts'):
    """Exact-protocol multi-restart AA with convergence compaction
    (see :func:`_compacted_best` for the scheduler semantics; with
    ``mesh`` each restart group compacts its local restarts).

    Returns ``(best, costs, n_iters)`` with the
    :func:`_keep_best_over_chunks` contract:
    ``best = (Z, C, alpha, trace, best_cost, best_n_iter)``.
    """
    n_groups = 1 if mesh is None else mesh.shape[restart_axis]
    keys, n_valid = _pad_keys(keys, n_groups)
    R = keys.shape[0]
    shared = dict(criterion=statics['criterion'],
                  do_scale=statics['do_scale'],
                  has_data=statics['has_data'],
                  dict_cfg=statics['dict_cfg'],
                  weights_cfg=statics['weights_cfg'],
                  scale_cfg=statics['scale_cfg'],
                  weights_backend=grouped_backend,
                  mesh=mesh,
                  restart_axis=None if mesh is None else restart_axis)

    n_samples = X.shape[0]
    k = statics['n_components']
    X = jnp.asarray(X)
    dtype = X.dtype
    # Gram once per fit (advisor round 3): every round-chunk program
    # takes it device-resident instead of re-deriving X @ X.T.
    gram = _gram_once(X) if statics['has_data'] else X
    states_all = (jnp.zeros((R, n_samples, k), dtype),
                  jnp.zeros((R, k, n_samples), dtype),
                  jnp.ones((R, k), dtype))

    def make_round_call(fresh, M_round):
        runner = _make_aa_grouped_round_run(
            fresh=fresh, max_iterations=M_round,
            n_components=k, init=statics['init'] if fresh else None,
            n_extra_steps=statics['n_extra_steps'] if fresh else None,
            **shared)
        if mesh is None:
            # Single-chip runner takes flat (chunk,) index/mask rows;
            # the scheduler always hands (n_groups=1, chunk).
            return lambda st, idx, wm: runner(
                X, gram, keys, st, idx[0], wm[0], delta, tolerance,
                component_mask)
        return lambda st, idx, wm: runner(X, gram, keys, st, idx, wm,
                                          delta, tolerance,
                                          component_mask)

    states_all, costs, n_iters, traces, best = _compacted_best(
        R, states_all, max_iterations=int(statics['max_iterations']),
        restart_chunk=restart_chunk, round_iterations=round_iterations,
        make_round_call=make_round_call, n_groups=n_groups,
        n_valid=n_valid)

    Z_all, C_all, a_all = states_all
    trace_b = (np.concatenate(traces[best]) if traces[best]
               else np.zeros((0,)))
    best_tuple = (Z_all[best], C_all[best], a_all[best],
                  trace_b, float(costs[best]), int(n_iters[best]))
    return best_tuple, costs[:n_valid], n_iters[:n_valid]


def _validate_compaction(compact_iterations, mesh, screen_iterations,
                         grouped):
    """Shared argument validation for ``compact_iterations`` (AA,
    KernelAA, and GPNH restart entry points).  Returns the resolved
    ``grouped`` flag (compaction needs the grouped, state-resumable
    runners; with ``mesh`` the rounds run shard_map'd with each
    restart group compacting its local queue)."""
    if compact_iterations is None:
        return grouped
    if screen_iterations is not None:
        raise ValueError("compact_iterations and screen_iterations "
                         "are mutually exclusive (compaction is the "
                         "exact-protocol scheduler, screening the "
                         "pruning heuristic)")
    grouped = True if grouped is None else grouped
    if not grouped:
        raise ValueError("compact_iterations requires the grouped "
                         "restart structure (grouped=False given)")
    return grouped


def _grouped_backend(mesh, grouped, weights_cfg, k):
    """Resolve whether the single-chip restart batch should use the
    grouped runners, and with which QP backend.

    ``grouped=None`` (auto): grouped iff ``mesh is None`` and the
    weights backend resolves to 'pallas' under the grouped-fit regime
    (the GPU, k within the kernel's limit) — the configuration measured
    fastest at protocol scale (``solvers.spg.resolve_qp_backend``).
    ``True``
    forces the grouped structure (XLA backend included; mesh must be
    None), ``False`` forces the legacy vmapped path.
    """
    if grouped is False or (mesh is not None and grouped is None):
        return None
    if grouped and mesh is not None:
        raise ValueError("grouped=True requires mesh=None; mesh-sharded "
                         "fits already group via sharded_aa_fit")
    backend = resolve_qp_backend(weights_cfg.backend, k=k,
                                 regime='sharded_fit')
    if grouped is None and backend != 'pallas':
        return None
    return backend


@functools.lru_cache(maxsize=128)
def _make_aa_screen_run(mesh, restart_axis, *, n_components, init,
                        max_iterations, n_extra_steps, criterion,
                        do_scale, has_data, dict_cfg, weights_cfg,
                        scale_cfg):
    """Jitted screening runner: every restart's state after a bounded
    number of iterations (stacked, no keep-best reduction).  With
    ``mesh`` the key batch shards over ``restart_axis`` and the stacked
    outputs come back restart-sharded."""
    statics = dict(n_components=n_components, init=init,
                   max_iterations=max_iterations,
                   n_extra_steps=n_extra_steps, criterion=criterion,
                   do_scale=do_scale, has_data=has_data,
                   dict_cfg=dict_cfg, weights_cfg=weights_cfg,
                   scale_cfg=scale_cfg)

    def screen_batch(X, keys, delta, tolerance, component_mask):
        K, diss, data = _prepare_aa_inputs(X, has_data, init)
        Zs, Cs, alphas, costs, n_iters, _ = _aa_fit_batch(
            data, K, diss, keys, delta, tolerance, component_mask,
            **statics)
        return Zs, Cs, alphas, costs, n_iters

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, keys, delta, tolerance, component_mask=None):
            return screen_batch(X, keys, delta, tolerance,
                                component_mask)
        return run

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, delta, tolerance, component_mask=None):
        return functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(restart_axis, None), P(), P(), P()),
            out_specs=(P(restart_axis, None, None),
                       P(restart_axis, None, None),
                       P(restart_axis, None),
                       P(restart_axis),
                       P(restart_axis)),
            check_vma=_sharded_aa.CHECK_VMA)(screen_batch)(
                X, keys, delta, tolerance, component_mask)

    return run


@functools.lru_cache(maxsize=128)
def _make_aa_resume_run(mesh, restart_axis, *, max_iterations, criterion,
                        do_scale, has_data, dict_cfg, weights_cfg,
                        scale_cfg):
    """Jitted resume runner: continue a batch of fits from explicit
    (Z, C, alpha) states to convergence, then keep the best.  With
    ``mesh`` the state batch shards over ``restart_axis``; ``n_valid``
    (runtime) masks tiled pad restarts out of the selection."""

    def resume_batch(X, Zs, Cs, alphas, delta, tolerance,
                     component_mask):
        K, _, data = _prepare_aa_inputs(X, has_data, init=None)

        def resume_one(Z, C, alpha):
            return _kernel_aa_core(
                K, Z, C, alpha, delta, tolerance, data, component_mask,
                do_scale=do_scale, do_dict=True, do_weights=True,
                criterion=criterion, max_iterations=max_iterations,
                require_monotonic=False, has_data=has_data,
                dict_cfg=dict_cfg, weights_cfg=weights_cfg,
                scale_cfg=scale_cfg)[:7]

        return jax.vmap(resume_one)(Zs, Cs, alphas)

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, Zs, Cs, alphas, delta, tolerance,
                component_mask=None, n_valid=None):
            Zs, Cs, alphas, costs, n_iters, traces, _ = resume_batch(
                X, Zs, Cs, alphas, delta, tolerance, component_mask)
            best = jnp.argmin(costs)
            return (Zs[best], Cs[best], alphas[best], traces[best],
                    costs, n_iters, costs[best], n_iters[best])
        return run

    @apply_matmul_precision
    @jax.jit
    def run(X, Zs, Cs, alphas, delta, tolerance, component_mask=None,
            n_valid=None):
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(restart_axis, None, None),
                      P(restart_axis, None, None),
                      P(restart_axis, None), P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P(),
                       P(restart_axis), P(restart_axis), P(), P()),
            check_vma=_sharded_aa.CHECK_VMA)
        def shard_resume(X, Zs_loc, Cs_loc, alphas_loc, delta,
                         tolerance, component_mask, n_valid):
            Zs_l, Cs_l, alphas_l, costs, n_iters, traces, _ = \
                resume_batch(X, Zs_loc, Cs_loc, alphas_loc, delta,
                             tolerance, component_mask)
            best, best_cost, best_n_iter, best_trace = _select_best(
                (Zs_l, Cs_l, alphas_l), costs, traces, n_iters,
                n_valid=n_valid, restart_axis=restart_axis)
            Z, C, alpha = best
            return (Z, C, alpha, best_trace, costs, n_iters,
                    best_cost, best_n_iter)

        return shard_resume(X, Zs, Cs, alphas, delta, tolerance,
                            component_mask,
                            jnp.asarray(n_valid, jnp.int32))

    return run


def _screened_best(screen_call, resume_call, keys, *, chunk, axis_size,
                   screen_keep, screen_margin=None):
    """Generic two-phase screened keep-best driver (AA and GPNH).

    ``screen_call(key_chunk) -> (*state, costs, n_iters)`` stacked over
    the chunk; ``resume_call(state_tuple, n_valid) -> (*best_state,
    costs, n_iters, best_cost, best_n_iter)``.  Both phases are chunked
    (bounded device executions, see :func:`_keep_best_over_chunks`);
    with a mesh, key chunks and survivor states are tiled to the
    restart-axis size and the tiled duplicates are masked out of the
    selection by the runtime ``n_valid``.

    ``screen_margin`` (optional, cost units) guards the pruning
    heuristic: in addition to the best ``screen_keep`` fraction, every
    restart whose screened cost lies within ``screen_margin`` of the
    fractional cut also survives — so a near-tied true winner cannot be
    pruned by a hair at the cut.  Returns ``(best, costs, n_iters,
    screen_diag)`` where ``screen_diag`` reports the cut, the kept
    count, and the OBSERVED margin (best pruned screened cost minus
    worst kept): a small observed margin means the cut landed inside a
    cost plateau and the caller should consider a nonzero
    ``screen_margin`` (or no screening).
    """
    n_init = keys.shape[0]
    if axis_size > 1:
        chunk = max(chunk, axis_size)

    state_acc, costs_acc, iters_acc = None, [], []
    for i in range(0, n_init, chunk):
        key_chunk, n_valid = _pad_keys(keys[i:i + chunk], axis_size)
        *state, costs, n_iters = screen_call(key_chunk)
        if state_acc is None:
            state_acc = [[] for _ in state]
        for acc, val in zip(state_acc, state):
            acc.append(val[:n_valid])
        costs_acc.append(np.asarray(costs)[:n_valid])
        iters_acc.append(np.asarray(n_iters)[:n_valid])
    state = tuple(jnp.concatenate(a) for a in state_acc)
    screen_costs = np.concatenate(costs_acc)
    screen_iters = np.concatenate(iters_acc)

    order = np.argsort(screen_costs)
    n_keep = max(1, int(np.ceil(float(screen_keep) * n_init)))
    cut = float(screen_costs[order[n_keep - 1]])
    if screen_margin is not None:
        n_keep = max(n_keep, int(np.sum(
            screen_costs <= cut + float(screen_margin))))
    survivors = order[:n_keep]
    pruned = order[n_keep:]
    screen_diag = {
        'n_screened': int(n_init),
        'n_kept': int(n_keep),
        'screen_cut': cut,
        'screen_margin_observed': (
            float(screen_costs[pruned].min()
                  - screen_costs[survivors].max())
            if pruned.size else float('inf')),
    }

    best = None
    res_costs, res_iters = [], []
    for i in range(0, n_keep, chunk):
        sl = survivors[i:i + chunk]
        n_valid = len(sl)
        if axis_size > 1 and n_valid % axis_size:
            # Tile the survivor indices up to the axis size; the tiled
            # duplicates are masked out of the selection by n_valid.
            sl = np.resize(sl, n_valid + (-n_valid) % axis_size)
        idx = jnp.asarray(sl)
        out = resume_call(tuple(s[idx] for s in state), n_valid)
        *bstate, costs_c, iters_c, best_cost, best_n_iter = out
        res_costs.append(np.asarray(costs_c)[:n_valid])
        res_iters.append(np.asarray(iters_c)[:n_valid])
        if best is None or float(best_cost) < best[-2]:
            best = (*bstate, float(best_cost), int(best_n_iter))
    res_costs = np.concatenate(res_costs)
    res_iters = np.concatenate(res_iters)

    all_costs = screen_costs.copy()
    all_iters = screen_iters.copy()
    all_costs[survivors] = res_costs
    all_iters[survivors] = screen_iters[survivors] + res_iters
    # best's n_iter / trace cover the resume phase of the winner (its
    # screening iterations are in ``n_iters``); slicing the trace with
    # the phase count keeps cost_deltas consistent.
    return best, all_costs, all_iters, screen_diag


def _screened_aa_best(X, keys, delta, tolerance, component_mask, *,
                      screen_iterations, screen_keep, restart_chunk,
                      statics, mesh=None, restart_axis='restarts',
                      grouped_backend=None, screen_margin=None):
    """AA instantiation of :func:`_screened_best` (screen -> prune ->
    resume); with ``mesh`` both phases run shard_map'd over
    ``restart_axis``; with ``grouped_backend`` both phases run the
    single-chip grouped runners (weights QP batched across restarts)."""
    axis_size = 1 if mesh is None else mesh.shape[restart_axis]
    screen_statics = {k: v for k, v in statics.items()
                      if k != 'max_iterations'}
    resume_statics = {k: statics[k]
                      for k in ('max_iterations', 'criterion', 'do_scale',
                                'has_data', 'dict_cfg', 'weights_cfg',
                                'scale_cfg')}
    if grouped_backend is not None:
        screen = _make_aa_grouped_screen_run(
            max_iterations=int(screen_iterations),
            weights_backend=grouped_backend, **screen_statics)
        resume = _make_aa_grouped_resume_run(
            weights_backend=grouped_backend, **resume_statics)
    else:
        screen = _make_aa_screen_run(
            mesh, restart_axis, max_iterations=int(screen_iterations),
            **screen_statics)
        resume = _make_aa_resume_run(mesh, restart_axis, **resume_statics)

    def screen_call(key_chunk):
        return screen(X, key_chunk, delta, tolerance, component_mask)

    def resume_call(state, n_valid):
        Zs, Cs, alphas = state
        return resume(X, Zs, Cs, alphas, delta, tolerance,
                      component_mask, n_valid)

    return _screened_best(screen_call, resume_call, keys,
                          chunk=restart_chunk or keys.shape[0],
                          axis_size=axis_size, screen_keep=screen_keep,
                          screen_margin=screen_margin)


def _keep_best_over_chunks(call, keys, chunk_size, mesh_axis_size):
    """Drive ``call(key_chunk, n_valid)`` over restart-key chunks,
    keeping the best state.

    ``restart_chunk`` bounds how many restarts run in one device
    execution (large k x many restarts x many iterations), with
    identical keep-best semantics.  Whether the H100 needs the bound,
    and at what size, is not yet measured.

    ``call`` returns ``(*state, costs, n_iters, best_cost,
    best_n_iter)`` for its chunk (any state arity — AA returns
    (Z, C, alpha, trace), GPNH (Z, W, trace)).  Returns
    ``((*state, best_cost, best_n_iter), costs, n_iters)`` over all
    chunks, pad restarts excluded.
    """
    n_init = keys.shape[0]
    if chunk_size is None or chunk_size >= n_init:
        chunks = [keys]
    else:
        if mesh_axis_size > 1:
            chunk_size = max(chunk_size, mesh_axis_size)
        chunks = [keys[i:i + chunk_size]
                  for i in range(0, n_init, chunk_size)]

    best = None
    all_costs, all_n_iters = [], []
    for chunk in chunks:
        n_valid = chunk.shape[0]
        if mesh_axis_size > 1:
            chunk, n_valid = _pad_keys(chunk, mesh_axis_size)
        out = call(chunk, n_valid)
        *state, costs, n_iters, best_cost, best_n_iter = out
        all_costs.append(np.asarray(costs)[:n_valid])
        all_n_iters.append(np.asarray(n_iters)[:n_valid])
        if best is None or float(best_cost) < best[-2]:
            best = (*state, float(best_cost), int(best_n_iter))
    costs = np.concatenate(all_costs)
    n_iters = np.concatenate(all_n_iters)
    return best, costs, n_iters


def aa_fit_restarts(data, n_components, key, n_init, delta=0.0,
                    init='furthest_sum', tolerance=1e-6,
                    max_iterations=500, n_extra_steps=10,
                    stopping_criterion='abs_delta_f',
                    dictionary_solver_kwargs=None,
                    weights_solver_kwargs=None,
                    scale_factors_solver_kwargs=None,
                    mesh=None, restart_axis='restarts',
                    restart_chunk=None, pad_components_to=None,
                    screen_iterations=None, screen_keep=0.25,
                    screen_margin=None,
                    grouped=None, compact_iterations=None):
    """Best-of-``n_init`` archetypal analysis, fully on device.

    ``data``: (n_samples, n_features) matrix.  Returns a dict with the
    best restart's ``weights``, ``dictionary``, ``alpha``,
    ``archetypes``, ``cost``, ``n_iter``, plus ``costs`` for all
    restarts.  With ``mesh`` given, the restart batch runs under
    ``shard_map`` over ``restart_axis`` (structurally partitioned; see
    module docstring).

    ``pad_components_to`` runs the fit padded to that component count
    with a runtime mask pinning the extra components to zero weight —
    the result is exactly an ``n_components`` model, but every ``k``
    sharing a pad size reuses one compiled program (kills the per-``k``
    recompile in model-selection sweeps; see
    ``parallel.sweep.aa_model_selection_sweep``).  With
    ``init='furthest_sum'`` the ``extra_steps`` refinement sees the
    padded count, so the selected seeds may differ from an unpadded
    run (still a valid FurthestSum init of the active components).

    ``screen_iterations`` enables two-phase *screened* restarts: every
    restart runs a bounded screening pass of that many iterations, then
    only the best ``screen_keep`` fraction continues to convergence.
    The lockstep restart batch pays for its slowest member (measured
    HadISST protocol: max 465 vs mean 170 iterations), so screening
    cuts the straggler cost; it is a heuristic — the final winner is
    identical to the unscreened run whenever the eventual best restart
    ranks inside the kept fraction after screening (the usual case:
    restart quality is strongly ordered early).  Off by default; the
    reference protocol runs every restart to convergence.  With
    screening, the returned ``n_iter``/``cost_deltas`` describe the
    winner's resume phase and ``n_iters`` holds per-restart totals.
    Composes with ``mesh``: both phases run shard_map'd over
    ``restart_axis``.

    ``screen_margin`` (cost units) guards the screening heuristic:
    every restart whose screened cost is within that margin of the
    fractional cut ALSO survives, so a near-tied eventual winner cannot
    be pruned by a hair.  Screened results carry a ``screen`` dict with
    ``screen_cut``, ``n_kept``, and ``screen_margin_observed`` (best
    pruned screened cost minus worst kept) — inspect it to size the
    margin for a new dataset.

    ``grouped`` selects the single-chip restart-batch structure:
    ``None`` (auto) uses the grouped runners — weights QP batched
    ACROSS restarts through one fused kernel, per-restart freezing via
    ``sharded_aa._keep_best_loop`` — whenever ``mesh is None`` and the
    weights backend resolves to 'pallas' (the configuration measured
    fastest at protocol scale; ``solvers.spg.resolve_qp_backend``).
    ``False`` forces the legacy
    vmapped-per-restart path; ``True`` forces grouped (mesh must be
    None).  Keep-best semantics are identical; per-restart trajectories
    can differ at solver-internals level (the grouped QP runs each row
    to its own fixed point instead of chunk-lockstep).

    ``compact_iterations`` turns on convergence COMPACTION (single-chip,
    grouped structure; exact protocol semantics): restarts run in
    bounded rounds of that many iterations, converged restarts retire
    after each round, and the survivors are re-packed into dense
    ``restart_chunk``-wide batches, so the batch width tracks the
    population still iterating instead of paying the per-chunk
    straggler tax (max ~2.2x mean iterations at the HadISST protocol).
    Unlike screening this changes scheduling only — every restart still
    runs to its own convergence and the keep-best winner is identical
    (see :func:`_compacted_aa_best`).  Mutually exclusive with
    ``screen_iterations``.  Composes with ``mesh``: each restart group
    compacts its LOCAL restart queue (the round programs shard over
    ``restart_axis`` with no cross-group collectives, so per-restart
    trajectories match the single-chip schedule; a group that drains
    early idles in lockstep re-running masked dummy rows until the
    slowest group's round finishes).
    """
    X = jnp.asarray(data)

    dict_cfg = make_config(SPGSolverConfig, dictionary_solver_kwargs)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)
    scale_cfg = make_config(SPGSolverConfig, scale_factors_solver_kwargs)

    keys = jax.random.split(key, n_init)
    do_scale = float(delta) != 0.0
    axis_size = 1 if mesh is None else mesh.shape[restart_axis]

    k_out = int(n_components)
    k_fit, component_mask = _padded_components(k_out, pad_components_to)

    statics = dict(n_components=k_fit, init=init,
                   max_iterations=int(max_iterations),
                   n_extra_steps=int(n_extra_steps),
                   criterion=stopping_criterion, do_scale=do_scale,
                   has_data=True, dict_cfg=dict_cfg,
                   weights_cfg=weights_cfg, scale_cfg=scale_cfg)

    grouped = _validate_compaction(compact_iterations, mesh,
                                   screen_iterations, grouped)
    if compact_iterations is not None:
        # Compaction always uses the grouped round runners; under a
        # mesh the rounds shard over the restart axis, so the backend
        # resolves with sharded-fit semantics either way.
        grouped_backend = resolve_qp_backend(
            weights_cfg.backend, k=k_fit, regime='sharded_fit')
    else:
        grouped_backend = _grouped_backend(mesh, grouped, weights_cfg,
                                           k_fit)

    screen_diag = None
    if compact_iterations is not None:
        best, costs, n_iters = _compacted_aa_best(
            X, keys, jnp.asarray(delta, X.dtype),
            jnp.asarray(tolerance, X.dtype), component_mask,
            statics=statics, grouped_backend=grouped_backend,
            restart_chunk=restart_chunk,
            round_iterations=int(compact_iterations),
            mesh=mesh, restart_axis=restart_axis)
    elif screen_iterations is not None:
        best, costs, n_iters, screen_diag = _screened_aa_best(
            X, keys, jnp.asarray(delta, X.dtype),
            jnp.asarray(tolerance, X.dtype), component_mask,
            screen_iterations=int(screen_iterations),
            screen_keep=float(screen_keep),
            restart_chunk=restart_chunk, statics=statics,
            mesh=mesh, restart_axis=restart_axis,
            grouped_backend=grouped_backend,
            screen_margin=screen_margin)
    else:
        if grouped_backend is not None:
            run = _make_aa_grouped_run(weights_backend=grouped_backend,
                                       **statics)
        else:
            run = _make_aa_run(mesh, restart_axis, **statics)
        delta_op = jnp.asarray(delta, X.dtype)
        tol_op = jnp.asarray(tolerance, X.dtype)

        def call(chunk, n_valid):
            return run(X, chunk, delta_op, tol_op, component_mask,
                       jnp.asarray(n_valid, jnp.int32))

        best, costs, n_iters = _keep_best_over_chunks(
            call, keys, restart_chunk, axis_size)

    Z, C, alpha, trace, best_cost, n_iter_best = best
    if component_mask is not None:
        Z, C, alpha = Z[:, :k_out], C[:k_out], alpha[:k_out]
    cost_deltas = np.asarray(trace)[:n_iter_best]
    dictionary = alpha[:, None] * C if do_scale else C
    archetypes = dictionary @ X

    out = {
        'weights': Z,
        'dictionary': dictionary,
        'alpha': alpha,
        'archetypes': archetypes,
        'cost': best_cost,
        'n_iter': n_iter_best,
        'cost_deltas': cost_deltas,
        'costs': costs,
        'n_iters': n_iters,
        'best_index': int(np.argmin(costs)),
    }
    if screen_diag is not None:
        out['screen'] = screen_diag
    return out


def kernel_aa_fit_restarts(kernel, n_components, key, n_init, delta=0.0,
                           init='furthest_sum', tolerance=1e-6,
                           max_iterations=500, n_extra_steps=10,
                           stopping_criterion='abs_delta_f',
                           dictionary_solver_kwargs=None,
                           weights_solver_kwargs=None,
                           scale_factors_solver_kwargs=None,
                           mesh=None, restart_axis='restarts',
                           restart_chunk=None, pad_components_to=None,
                           screen_iterations=None, screen_keep=0.25,
                           screen_margin=None,
                           grouped=None, compact_iterations=None):
    """Best-of-``n_init`` kernel AA on a precomputed kernel matrix.

    Kernel-space analog of :func:`aa_fit_restarts` for ``KernelAA``
    users (no data matrix; the outer-loop cost uses the kernel trace
    form), including two-phase screened restarts
    (``screen_iterations``/``screen_keep``, composing with ``mesh``),
    the ``grouped`` single-chip restart-batch structure, padded-``k``
    program reuse (``pad_components_to``), and convergence compaction
    (``compact_iterations``) — all with the semantics documented on
    :func:`aa_fit_restarts`.  Returns a dict with the best restart's
    ``weights``, ``dictionary``, ``alpha``, ``cost``, ``n_iter``,
    ``cost_deltas``, plus ``costs``/``n_iters`` for every restart.
    """
    K = jnp.asarray(kernel)
    dict_cfg = make_config(SPGSolverConfig, dictionary_solver_kwargs)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)
    scale_cfg = make_config(SPGSolverConfig, scale_factors_solver_kwargs)

    keys = jax.random.split(key, n_init)
    do_scale = float(delta) != 0.0
    axis_size = 1 if mesh is None else mesh.shape[restart_axis]

    k_out = int(n_components)
    k_fit, component_mask = _padded_components(k_out, pad_components_to)

    statics = dict(n_components=k_fit, init=init,
                   max_iterations=int(max_iterations),
                   n_extra_steps=int(n_extra_steps),
                   criterion=stopping_criterion, do_scale=do_scale,
                   has_data=False, dict_cfg=dict_cfg,
                   weights_cfg=weights_cfg, scale_cfg=scale_cfg)
    delta_op = jnp.asarray(delta, K.dtype)
    tol_op = jnp.asarray(tolerance, K.dtype)

    grouped = _validate_compaction(compact_iterations, mesh,
                                   screen_iterations, grouped)
    if compact_iterations is not None:
        grouped_backend = resolve_qp_backend(
            weights_cfg.backend, k=k_fit, regime='sharded_fit')
    else:
        grouped_backend = _grouped_backend(mesh, grouped, weights_cfg,
                                           k_fit)

    screen_diag = None
    if compact_iterations is not None:
        best, costs, n_iters = _compacted_aa_best(
            K, keys, delta_op, tol_op, component_mask,
            statics=statics, grouped_backend=grouped_backend,
            restart_chunk=restart_chunk,
            round_iterations=int(compact_iterations),
            mesh=mesh, restart_axis=restart_axis)
    elif screen_iterations is not None:
        best, costs, n_iters, screen_diag = _screened_aa_best(
            K, keys, delta_op, tol_op, component_mask,
            screen_iterations=int(screen_iterations),
            screen_keep=float(screen_keep),
            restart_chunk=restart_chunk, statics=statics,
            mesh=mesh, restart_axis=restart_axis,
            grouped_backend=grouped_backend,
            screen_margin=screen_margin)
    else:
        if grouped_backend is not None:
            run = _make_aa_grouped_run(weights_backend=grouped_backend,
                                       **statics)
        else:
            run = _make_aa_run(mesh, restart_axis, **statics)

        def call(chunk, n_valid):
            return run(K, chunk, delta_op, tol_op, component_mask,
                       jnp.asarray(n_valid, jnp.int32))

        best, costs, n_iters = _keep_best_over_chunks(
            call, keys, restart_chunk, axis_size)

    Z, C, alpha, trace, best_cost, n_iter_best = best
    if component_mask is not None:
        Z, C, alpha = Z[:, :k_out], C[:k_out], alpha[:k_out]
    out = {
        'weights': Z,
        'dictionary': C,
        'alpha': alpha,
        'cost': best_cost,
        'n_iter': n_iter_best,
        'cost_deltas': np.asarray(trace)[:n_iter_best],
        'costs': costs,
        'n_iters': n_iters,
        'best_index': int(np.argmin(costs)),
    }
    if screen_diag is not None:
        out['screen'] = screen_diag
    return out


# ---------------------------------------------------------------------------
# GPNH convex coding
# ---------------------------------------------------------------------------


def _init_gpnh_state(key, X, diss, *, n_components, init, n_extra_steps,
                     component_mask=None):
    """One restart's (Z, W) initialization (reference
    gpnh_convex_coding.py:41-81), shared by the vmapped and grouped
    restart batches.

    ``component_mask`` runs a padded-``k`` init: padded dictionary and
    weight columns start at exact zero (the masked core keeps them
    there), and the random dictionary scale uses the ACTIVE component
    count (reference ``avg = sqrt(mean|X|/k)``, :41-49) so the active
    columns are initialized exactly as an unpadded ``k_act`` fit's.
    """
    n_samples, n_features = X.shape
    dtype = X.dtype
    k_start, k_dict, k_weights = jax.random.split(key, 3)
    if component_mask is None:
        k_act = n_components
    else:
        k_act = jnp.sum(component_mask.astype(dtype))
    if init == 'furthest_sum':
        # Reference init: dictionary columns are the FurthestSum-
        # selected data rows (gpnh_convex_coding.py:52-81), selected
        # on device and vmapped over per-restart random starts.
        start = jax.random.randint(k_start, (), 0, n_samples)
        selected = furthest_sum_device(
            diss, n_components, start, extra_steps=n_extra_steps)
        W = X[selected].T
    else:
        avg = jnp.sqrt(jnp.mean(jnp.abs(X)) / k_act)
        W = avg * jax.random.normal(
            k_dict, (n_features, n_components), dtype=dtype)
    if component_mask is None:
        Z = right_stochastic_matrix(
            k_weights, (n_samples, n_components), dtype=dtype)
    else:
        W = W * component_mask.astype(dtype)[None, :]
        u = jax.random.uniform(
            k_weights, (n_samples, n_components), dtype=dtype)
        u = u * component_mask.astype(dtype)
        Z = u / jnp.sum(u, axis=1, keepdims=True)
    return Z, W


def _gpnh_fit_batch(X, diss, keys, lambda_W, tolerance,
                    component_mask=None, *, n_components,
                    init, max_iterations, n_extra_steps, criterion,
                    weights_cfg):
    from ..models.gpnh_convex_coding import _gpnh_core

    def fit_one(key):
        Z, W = _init_gpnh_state(key, X, diss, n_components=n_components,
                                init=init, n_extra_steps=n_extra_steps,
                                component_mask=component_mask)
        Z, W, cost, n_iter, trace, _, _ = _gpnh_core(
            X, Z, W, lambda_W, tolerance, component_mask,
            do_dict=True, do_weights=True, criterion=criterion,
            max_iterations=max_iterations, require_monotonic=False,
            weights_cfg=weights_cfg)
        return Z, W, cost, n_iter, trace

    return jax.vmap(fit_one)(keys)


def _gpnh_grouped_iterate(X, *, lambda_W, weights_backend,
                          weights_kwargs, n_components,
                          component_mask=None):
    """Restart-batched GPNH iterate with the weights QP grouped across
    restarts (single-device analog of ``sharded_aa.sharded_gpnh_fit``'s
    inner ``iterate_batch``; per-iteration math mirrors
    ``models.gpnh_convex_coding._gpnh_core`` — exact k x k lstsq
    dictionary solve, reference gpnh_convex_coding.py:213-226, then the
    per-row simplex QP :229-251 — with the trace-form objective).
    ``component_mask`` runs padded-``k`` fits (active-``k`` penalty,
    masked QP, zeroed padded dictionary columns; see
    ``models.gpnh_convex_coding._gpnh_core``)."""
    from ..models.gpnh_convex_coding import (_cost_from_parts as
                                             _gpnh_cost_from_parts,
                                             _gpnh_gram,
                                             _gpnh_gram_masked,
                                             gpnh_regularization,
                                             gpnh_regularization_masked)

    n_samples, n_features = X.shape
    sdt = _scalar_dtype(X.dtype)
    trace_XtX = jnp.sum(X.astype(sdt) * X.astype(sdt))
    if component_mask is None:
        GW = _gpnh_gram(n_features, n_components, X.dtype)
    else:
        GW = _gpnh_gram_masked(n_features, component_mask, X.dtype)

    def penalty(W):
        if component_mask is None:
            if_nonzero = gpnh_regularization(W).astype(sdt)
        else:
            if_nonzero = gpnh_regularization_masked(
                W, component_mask).astype(sdt)
        return jnp.where(lambda_W != 0, lambda_W * if_nonzero, 0.0)

    def dict_update(Z):
        ZtZ = Z.T @ Z
        ZtX = Z.T @ X
        lhs = ZtZ / n_samples + lambda_W * GW
        W = jnp.linalg.lstsq(lhs, ZtX / n_samples)[0].T
        if component_mask is not None:
            W = W * component_mask.astype(W.dtype)[None, :]
        return W, W.T @ W, -(X @ W)

    def cost_of(Z, W, WtW, XW):
        WtXtZ_tr = jnp.sum(XW.astype(sdt) * Z.astype(sdt))
        return _gpnh_cost_from_parts(trace_XtX, WtXtZ_tr, Z.T @ Z, WtW,
                                     penalty(W), n_samples)

    def iterate(Zs, Ws):
        Ws, WtWs, Bs = jax.vmap(dict_update)(Zs)
        Zs = quad_simplex_spg_batch_grouped(
            WtWs, Bs, Zs, backend=weights_backend, mask=component_mask,
            **weights_kwargs)
        costs = jax.vmap(cost_of)(Zs, Ws, WtWs, -Bs)
        return Zs, Ws, costs

    def cost0(Zs, Ws):
        def one(Z, W):
            return cost_of(Z, W, W.T @ W, X @ W)
        return jax.vmap(one)(Zs, Ws)

    return iterate, cost0


@functools.lru_cache(maxsize=128)
def _make_gpnh_grouped_run(*, n_components, init, max_iterations,
                           n_extra_steps, criterion, weights_cfg,
                           weights_backend):
    """Grouped analog of ``_make_gpnh_run(mesh=None)`` (same call
    signature/return tuple; see :func:`_make_aa_grouped_run`)."""
    weights_kwargs = weights_cfg.kwargs()

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, lambda_W, tolerance, n_valid, component_mask=None):
        diss = (dissimilarities_from_kernel(X @ X.T)
                if init == 'furthest_sum' else None)
        Zs, Ws = jax.vmap(functools.partial(
            _init_gpnh_state, n_components=n_components, init=init,
            n_extra_steps=n_extra_steps,
            component_mask=component_mask), in_axes=(0, None, None))(
                keys, X, diss)
        iterate, cost0 = _gpnh_grouped_iterate(
            X, lambda_W=lambda_W, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, n_components=n_components,
            component_mask=component_mask)
        states, costs, trace, n_iters, _ = _keep_best_loop(
            (Zs, Ws), cost0(Zs, Ws), iterate, tolerance=tolerance,
            criterion=criterion, max_iterations=max_iterations)
        Zs, Ws = states
        masked = jnp.where(jnp.arange(costs.shape[0]) < n_valid,
                           costs, jnp.inf)
        best = jnp.argmin(masked)
        return (Zs[best], Ws[best], trace[best], costs, n_iters,
                costs[best], n_iters[best])

    return run


@functools.lru_cache(maxsize=128)
def _make_gpnh_grouped_screen_run(*, n_components, init, max_iterations,
                                  n_extra_steps, criterion, weights_cfg,
                                  weights_backend):
    """Grouped analog of ``_make_gpnh_screen_run(mesh=None)``."""
    weights_kwargs = weights_cfg.kwargs()

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, lambda_W, tolerance, component_mask=None):
        diss = (dissimilarities_from_kernel(X @ X.T)
                if init == 'furthest_sum' else None)
        Zs, Ws = jax.vmap(functools.partial(
            _init_gpnh_state, n_components=n_components, init=init,
            n_extra_steps=n_extra_steps,
            component_mask=component_mask), in_axes=(0, None, None))(
                keys, X, diss)
        iterate, cost0 = _gpnh_grouped_iterate(
            X, lambda_W=lambda_W, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, n_components=n_components,
            component_mask=component_mask)
        states, costs, _, n_iters, _ = _keep_best_loop(
            (Zs, Ws), cost0(Zs, Ws), iterate, tolerance=tolerance,
            criterion=criterion, max_iterations=max_iterations)
        Zs, Ws = states
        return Zs, Ws, costs, n_iters

    return run


@functools.lru_cache(maxsize=128)
def _make_gpnh_grouped_resume_run(*, max_iterations, criterion,
                                  weights_cfg, weights_backend):
    """Grouped analog of ``_make_gpnh_resume_run(mesh=None)``."""
    weights_kwargs = weights_cfg.kwargs()

    @apply_matmul_precision
    @jax.jit
    def run(X, Zs, Ws, lambda_W, tolerance, n_valid=None,
            component_mask=None):
        iterate, cost0 = _gpnh_grouped_iterate(
            X, lambda_W=lambda_W, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs,
            n_components=Ws.shape[-1], component_mask=component_mask)
        states, costs, trace, n_iters, _ = _keep_best_loop(
            (Zs, Ws), cost0(Zs, Ws), iterate, tolerance=tolerance,
            criterion=criterion, max_iterations=max_iterations)
        Zs, Ws = states
        best = jnp.argmin(costs)
        return (Zs[best], Ws[best], trace[best], costs, n_iters,
                costs[best], n_iters[best])

    return run


@functools.lru_cache(maxsize=128)
def _make_gpnh_grouped_round_run(*, fresh, max_iterations, criterion,
                                 weights_cfg, weights_backend,
                                 n_components, init=None,
                                 n_extra_steps=None, mesh=None,
                                 restart_axis=None):
    """One bounded, device-resident compaction round of grouped GPNH
    restarts — GPNH analog of :func:`_make_aa_grouped_round_run` (see
    that docstring for the gather/advance/scatter design and the
    mesh per-group wrapper; the population pytree here is
    ``(Z_all, W_all)``)."""
    weights_kwargs = weights_cfg.kwargs()

    def finish(X, states_all, idx, Zs, Ws, lambda_W, tolerance,
               component_mask, write_mask):
        iterate, cost0 = _gpnh_grouped_iterate(
            X, lambda_W=lambda_W, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, n_components=n_components,
            component_mask=component_mask)
        states, costs, trace, n_iters, done = _keep_best_loop(
            (Zs, Ws), cost0(Zs, Ws), iterate, tolerance=tolerance,
            criterion=criterion, max_iterations=max_iterations)
        Zs, Ws = states
        Z_all, W_all = states_all
        Zs = jnp.where(write_mask[:, None, None], Zs, Z_all[idx])
        Ws = jnp.where(write_mask[:, None, None], Ws, W_all[idx])
        Z_all = Z_all.at[idx].set(Zs)
        W_all = W_all.at[idx].set(Ws)
        return (Z_all, W_all), costs, trace, n_iters, done

    def round_local(X, keys_all, states_all, idx, write_mask, lambda_W,
                    tolerance, component_mask):
        if fresh:
            diss = (dissimilarities_from_kernel(X @ X.T)
                    if init == 'furthest_sum' else None)
            Zs, Ws = jax.vmap(functools.partial(
                _init_gpnh_state, n_components=n_components, init=init,
                n_extra_steps=n_extra_steps,
                component_mask=component_mask),
                in_axes=(0, None, None))(keys_all[idx], X, diss)
        else:
            Z_all, W_all = states_all
            Zs, Ws = Z_all[idx], W_all[idx]
        return finish(X, states_all, idx, Zs, Ws, lambda_W, tolerance,
                      component_mask, write_mask)

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, keys_all, states_all, idx, write_mask, lambda_W,
                tolerance, component_mask=None):
            return round_local(X, keys_all, states_all, idx, write_mask,
                               lambda_W, tolerance, component_mask)
        return run

    state_specs = (P(restart_axis, None, None),
                   P(restart_axis, None, None))

    @apply_matmul_precision
    @jax.jit
    def run(X, keys_all, states_all, idx, write_mask, lambda_W,
            tolerance, component_mask=None):
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(restart_axis, None), state_specs,
                      P(restart_axis, None), P(restart_axis, None),
                      P(), P(), P()),
            out_specs=(state_specs,
                       P(restart_axis, None),
                       P(restart_axis, None, None),
                       P(restart_axis, None),
                       P(restart_axis, None)),
            check_vma=_sharded_aa.CHECK_VMA)
        def shard_round(X, keys_loc, states_loc, idx_loc, wm_loc,
                        lambda_W, tolerance, component_mask):
            states_loc, cs, tr, ni, done = round_local(
                X, keys_loc, states_loc, idx_loc[0], wm_loc[0],
                lambda_W, tolerance, component_mask)
            return (states_loc, cs[None], tr[None], ni[None],
                    done[None])

        return shard_round(X, keys_all, states_all, idx, write_mask,
                           lambda_W, tolerance, component_mask)

    return run


def _compacted_gpnh_best(X, keys, lambda_W, tolerance, *, statics,
                         grouped_backend, restart_chunk,
                         round_iterations, component_mask=None,
                         mesh=None, restart_axis='restarts'):
    """Exact-protocol multi-restart GPNH with convergence compaction
    (scheduler semantics in :func:`_compacted_best`; with ``mesh`` each
    restart group compacts its local restarts; reference protocol
    bin/run_hadisst_gpnh.py:149-171 — best-of-n_init to convergence).

    Returns ``(best, costs, n_iters)`` with
    ``best = (Z, W, trace, best_cost, best_n_iter)``.
    """
    n_groups = 1 if mesh is None else mesh.shape[restart_axis]
    keys, n_valid = _pad_keys(keys, n_groups)
    R = keys.shape[0]
    k = statics['n_components']
    shared = dict(criterion=statics['criterion'],
                  weights_cfg=statics['weights_cfg'],
                  weights_backend=grouped_backend,
                  n_components=k, mesh=mesh,
                  restart_axis=None if mesh is None else restart_axis)

    X = jnp.asarray(X)
    n_samples, n_features = X.shape
    states_all = (jnp.zeros((R, n_samples, k), X.dtype),
                  jnp.zeros((R, n_features, k), X.dtype))

    def make_round_call(fresh, M_round):
        runner = _make_gpnh_grouped_round_run(
            fresh=fresh, max_iterations=M_round,
            init=statics['init'] if fresh else None,
            n_extra_steps=statics['n_extra_steps'] if fresh else None,
            **shared)
        if mesh is None:
            return lambda st, idx, wm: runner(
                X, keys, st, idx[0], wm[0], lambda_W, tolerance,
                component_mask)
        return lambda st, idx, wm: runner(X, keys, st, idx, wm,
                                          lambda_W, tolerance,
                                          component_mask)

    states_all, costs, n_iters, traces, best = _compacted_best(
        R, states_all, max_iterations=int(statics['max_iterations']),
        restart_chunk=restart_chunk, round_iterations=round_iterations,
        make_round_call=make_round_call, n_groups=n_groups,
        n_valid=n_valid)

    Z_all, W_all = states_all
    trace_b = (np.concatenate(traces[best]) if traces[best]
               else np.zeros((0,)))
    best_tuple = (Z_all[best], W_all[best], trace_b,
                  float(costs[best]), int(n_iters[best]))
    return best_tuple, costs[:n_valid], n_iters[:n_valid]


@functools.lru_cache(maxsize=128)
def _make_gpnh_run(mesh, restart_axis, *, n_components, init,
                   max_iterations, n_extra_steps, criterion, weights_cfg):
    """GPNH analog of :func:`_make_aa_run` (same runtime-``n_valid``
    program-reuse design)."""
    statics = dict(n_components=n_components, init=init,
                   max_iterations=max_iterations,
                   n_extra_steps=n_extra_steps, criterion=criterion,
                   weights_cfg=weights_cfg)

    def prepare(X):
        if init == 'furthest_sum':
            return dissimilarities_from_kernel(X @ X.T)
        return None

    def local_best(Zs, Ws, costs, n_iters, traces, n_valid):
        masked = jnp.where(jnp.arange(costs.shape[0]) < n_valid,
                           costs, jnp.inf)
        best = jnp.argmin(masked)
        return (Zs[best], Ws[best], traces[best], costs, n_iters,
                costs[best], n_iters[best])

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, keys, lambda_W, tolerance, n_valid,
                component_mask=None):
            diss = prepare(X)
            out = _gpnh_fit_batch(X, diss, keys, lambda_W, tolerance,
                                  component_mask, **statics)
            return local_best(*out, n_valid)
        return run

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, lambda_W, tolerance, n_valid, component_mask=None):
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(restart_axis, None), P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P(restart_axis), P(restart_axis),
                       P(), P()),
            check_vma=_sharded_aa.CHECK_VMA)
        def shard_fit(X, keys_loc, lambda_W, tolerance, n_valid,
                      component_mask):
            diss = prepare(X)
            Zs, Ws, costs, n_iters, traces = _gpnh_fit_batch(
                X, diss, keys_loc, lambda_W, tolerance, component_mask,
                **statics)
            best, best_cost, best_n_iter, best_trace = _select_best(
                (Zs, Ws), costs, traces, n_iters, n_valid=n_valid,
                restart_axis=restart_axis)
            Z, W = best
            return (Z, W, best_trace, costs, n_iters, best_cost,
                    best_n_iter)

        return shard_fit(X, keys, lambda_W, tolerance, n_valid,
                         component_mask)

    return run


@functools.lru_cache(maxsize=128)
def _make_gpnh_screen_run(mesh, restart_axis, *, n_components, init,
                          max_iterations, n_extra_steps, criterion,
                          weights_cfg):
    """GPNH screening runner: every restart's state after a bounded
    number of iterations (stacked, no keep-best reduction)."""
    statics = dict(n_components=n_components, init=init,
                   max_iterations=max_iterations,
                   n_extra_steps=n_extra_steps, criterion=criterion,
                   weights_cfg=weights_cfg)

    def screen_batch(X, keys, lambda_W, tolerance, component_mask):
        diss = (dissimilarities_from_kernel(X @ X.T)
                if init == 'furthest_sum' else None)
        Zs, Ws, costs, n_iters, _ = _gpnh_fit_batch(
            X, diss, keys, lambda_W, tolerance, component_mask,
            **statics)
        return Zs, Ws, costs, n_iters

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, keys, lambda_W, tolerance, component_mask=None):
            return screen_batch(X, keys, lambda_W, tolerance,
                                component_mask)
        return run

    @apply_matmul_precision
    @jax.jit
    def run(X, keys, lambda_W, tolerance, component_mask=None):
        return functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(restart_axis, None), P(), P(), P()),
            out_specs=(P(restart_axis, None, None),
                       P(restart_axis, None, None),
                       P(restart_axis),
                       P(restart_axis)),
            check_vma=_sharded_aa.CHECK_VMA)(screen_batch)(
                X, keys, lambda_W, tolerance, component_mask)

    return run


@functools.lru_cache(maxsize=128)
def _make_gpnh_resume_run(mesh, restart_axis, *, max_iterations,
                          criterion, weights_cfg):
    """GPNH resume runner: continue a batch of fits from explicit
    (Z, W) states to convergence, then keep the best."""
    from ..models.gpnh_convex_coding import _gpnh_core

    def resume_batch(X, Zs, Ws, lambda_W, tolerance, component_mask):
        def resume_one(Z, W):
            return _gpnh_core(
                X, Z, W, lambda_W, tolerance, component_mask,
                do_dict=True,
                do_weights=True, criterion=criterion,
                max_iterations=max_iterations, require_monotonic=False,
                weights_cfg=weights_cfg)[:6]

        return jax.vmap(resume_one)(Zs, Ws)

    if mesh is None:
        @apply_matmul_precision
        @jax.jit
        def run(X, Zs, Ws, lambda_W, tolerance, n_valid=None,
                component_mask=None):
            Zs, Ws, costs, n_iters, traces, _ = resume_batch(
                X, Zs, Ws, lambda_W, tolerance, component_mask)
            best = jnp.argmin(costs)
            return (Zs[best], Ws[best], traces[best], costs, n_iters,
                    costs[best], n_iters[best])
        return run

    @apply_matmul_precision
    @jax.jit
    def run(X, Zs, Ws, lambda_W, tolerance, n_valid=None,
            component_mask=None):
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(restart_axis, None, None),
                      P(restart_axis, None, None), P(), P(), P(), P()),
            out_specs=(P(), P(), P(),
                       P(restart_axis), P(restart_axis), P(), P()),
            check_vma=_sharded_aa.CHECK_VMA)
        def shard_resume(X, Zs_loc, Ws_loc, lambda_W, tolerance,
                         n_valid, component_mask):
            Zs_l, Ws_l, costs, n_iters, traces, _ = resume_batch(
                X, Zs_loc, Ws_loc, lambda_W, tolerance, component_mask)
            best, best_cost, best_n_iter, best_trace = _select_best(
                (Zs_l, Ws_l), costs, traces, n_iters, n_valid=n_valid,
                restart_axis=restart_axis)
            Z, W = best
            return (Z, W, best_trace, costs, n_iters, best_cost,
                    best_n_iter)

        return shard_resume(X, Zs, Ws, lambda_W, tolerance,
                            jnp.asarray(n_valid, jnp.int32),
                            component_mask)

    return run


def gpnh_fit_restarts(data, n_components, key, n_init, lambda_W=0.0,
                      init='random', tolerance=1e-6, max_iterations=500,
                      n_extra_steps=10,
                      stopping_criterion='abs_delta_f',
                      weights_solver_kwargs=None,
                      mesh=None, restart_axis='restarts',
                      restart_chunk=None, pad_components_to=None,
                      screen_iterations=None, screen_keep=0.25,
                      screen_margin=None,
                      grouped=None, compact_iterations=None):
    """Best-of-``n_init`` GPNH convex coding, fully on device.

    Vmapped analog of the reference drivers' serial keep-best loop for
    GPNH (bin/run_hadisst_gpnh.py:149-171), supporting both driver inits
    (``random`` and device-side ``furthest_sum``).  ``restart_chunk``
    bounds how many restarts run in one device execution (see
    :func:`_keep_best_over_chunks`).

    ``pad_components_to`` runs the fit padded to that component count
    with a runtime mask: the weights QP pins padded columns to exact
    zero and the GPNH penalty is evaluated with the ACTIVE component
    count over active columns
    (``models.gpnh_convex_coding.gpnh_regularization_masked``) — the
    result is exactly an ``n_components`` model, and every ``k``
    sharing a pad size reuses one compiled program (kills the per-``k``
    recompile in ``parallel.sweep.gpnh_model_selection_sweep``).
    ``screen_iterations``/``screen_keep`` enable two-phase screened
    restarts exactly as in :func:`aa_fit_restarts` (compose with
    ``mesh``), ``grouped`` selects the single-chip grouped restart
    structure (weights QP batched across restarts), and
    ``compact_iterations`` enables convergence compaction — bounded
    rounds with converged restarts retiring and survivors re-packed
    into dense chunks; exact protocol semantics, scheduling change
    only (see :func:`aa_fit_restarts` /
    :func:`_compacted_best`).  Returns a dict with the best restart's
    ``weights``, ``dictionary``, ``cost``, ``n_iter``, ``cost_deltas``
    plus the full ``costs``/``n_iters`` arrays.
    """
    if init not in ('random', 'furthest_sum'):
        raise ValueError(
            "gpnh_fit_restarts supports init='random' or "
            "'furthest_sum' (the reference drivers' choices)")

    X = jnp.asarray(data)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)

    keys = jax.random.split(key, n_init)
    axis_size = 1 if mesh is None else mesh.shape[restart_axis]
    lam_op = jnp.asarray(lambda_W, X.dtype)
    tol_op = jnp.asarray(tolerance, X.dtype)

    k_out = int(n_components)
    k_fit, component_mask = _padded_components(k_out, pad_components_to)

    grouped = _validate_compaction(compact_iterations, mesh,
                                   screen_iterations, grouped)
    if compact_iterations is not None:
        grouped_backend = resolve_qp_backend(
            weights_cfg.backend, k=k_fit, regime='sharded_fit')
    else:
        grouped_backend = _grouped_backend(mesh, grouped, weights_cfg,
                                           k_fit)

    screen_diag = None
    if compact_iterations is not None:
        statics = dict(n_components=k_fit, init=init,
                       max_iterations=int(max_iterations),
                       n_extra_steps=int(n_extra_steps),
                       criterion=stopping_criterion,
                       weights_cfg=weights_cfg)
        best, costs, n_iters = _compacted_gpnh_best(
            X, keys, lam_op, tol_op, statics=statics,
            grouped_backend=grouped_backend,
            restart_chunk=restart_chunk,
            round_iterations=int(compact_iterations),
            component_mask=component_mask,
            mesh=mesh, restart_axis=restart_axis)
    elif screen_iterations is not None:
        if grouped_backend is not None:
            screen = _make_gpnh_grouped_screen_run(
                n_components=k_fit, init=init,
                max_iterations=int(screen_iterations),
                n_extra_steps=int(n_extra_steps),
                criterion=stopping_criterion, weights_cfg=weights_cfg,
                weights_backend=grouped_backend)
            resume = _make_gpnh_grouped_resume_run(
                max_iterations=int(max_iterations),
                criterion=stopping_criterion, weights_cfg=weights_cfg,
                weights_backend=grouped_backend)
        else:
            screen = _make_gpnh_screen_run(
                mesh, restart_axis, n_components=k_fit,
                init=init, max_iterations=int(screen_iterations),
                n_extra_steps=int(n_extra_steps),
                criterion=stopping_criterion, weights_cfg=weights_cfg)
            resume = _make_gpnh_resume_run(
                mesh, restart_axis, max_iterations=int(max_iterations),
                criterion=stopping_criterion, weights_cfg=weights_cfg)

        def screen_call(key_chunk):
            return screen(X, key_chunk, lam_op, tol_op, component_mask)

        def resume_call(state, n_valid):
            Zs, Ws = state
            return resume(X, Zs, Ws, lam_op, tol_op, n_valid,
                          component_mask)

        best, costs, n_iters, screen_diag = _screened_best(
            screen_call, resume_call, keys,
            chunk=restart_chunk or n_init, axis_size=axis_size,
            screen_keep=screen_keep, screen_margin=screen_margin)
    else:
        if grouped_backend is not None:
            run = _make_gpnh_grouped_run(
                n_components=k_fit, init=init,
                max_iterations=int(max_iterations),
                n_extra_steps=int(n_extra_steps),
                criterion=stopping_criterion, weights_cfg=weights_cfg,
                weights_backend=grouped_backend)
        else:
            run = _make_gpnh_run(
                mesh, restart_axis, n_components=k_fit,
                init=init, max_iterations=int(max_iterations),
                n_extra_steps=int(n_extra_steps),
                criterion=stopping_criterion, weights_cfg=weights_cfg)

        def call(chunk, n_valid):
            return run(X, chunk, lam_op, tol_op,
                       jnp.asarray(n_valid, jnp.int32), component_mask)

        best, costs, n_iters = _keep_best_over_chunks(
            call, keys, restart_chunk, axis_size)

    Z, W, trace, best_cost, n_iter_best = best
    if component_mask is not None:
        Z, W = Z[:, :k_out], W[:, :k_out]
    out = {
        'weights': Z,
        'dictionary': W,
        'cost': best_cost,
        'n_iter': n_iter_best,
        'cost_deltas': np.asarray(trace)[:n_iter_best],
        'costs': costs,
        'n_iters': n_iters,
        'best_index': int(np.argmin(costs)),
    }
    if screen_diag is not None:
        out['screen'] = screen_diag
    return out
