"""Mesh-sharded model fits: explicit SPMD over (restarts, samples).

The scaling design for data too large (or restart counts too high) for
one chip.  Mesh axes:

- ``restarts``: independent fits, pure data parallelism (no collectives
  except the final keep-best selection).
- ``samples``: rows of the data matrix.  Per-row weight QPs are local;
  the k-sized contractions cross shards via collectives:
  ``psum`` for Z'Z / C@K / cost reductions, ``all_gather`` for the
  (n, k)-sized Z and KZD blocks.

Every device in a ``samples`` group computes identical replicated
scalars for the solvers' convergence tests and the outer stopping test,
so the ``lax.while_loop`` trip counts agree within each communicating
group and the in-loop ``psum``s cannot deadlock; restart groups never
communicate inside the loops, so their trip counts are free to differ.

:func:`sharded_aa_fit` / :func:`sharded_gpnh_fit` run the FULL
alternating fit to convergence under ``shard_map`` — including the
scale-factor (alpha) update for delta != 0 and the cross-mesh keep-best
selection — reproducing the math of the single-device cores
(models/archetypal_analysis._kernel_aa_core,
models/gpnh_convex_coding._gpnh_core) term by term so the cost
trajectories match the unsharded fits.

The reference has no distributed execution at all (SURVEY.md §2.4);
this module is the from-scratch multi-device scaling layer.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..models._common import (QPSolverConfig, SPGSolverConfig, make_config,
                              has_converged)
from ..models.archetypal_analysis import (_cost_from_parts,
                                          _spg_cfg_to_quad_kwargs)
from ..ops.simplex_projection import simplex_project_rows
from ..solvers.spg import (quad_spg, quad_simplex_spg_batch_grouped,
                           resolve_qp_backend)
from ..utils.precision import apply_matmul_precision
from ..utils.vma import pvary_like

__all__ = ["distributed_gram", "sharded_aa_train_step", "sharded_aa_fit",
           "sharded_kernel_aa_fit", "sharded_gpnh_fit"]

#: Static varying-manual-axes checking for every shard_map in the SPMD
#: layer — this module, ``parallel/restarts.py``,
#: ``parallel/sharded_models.py``, and the estimators' mesh routes all
#: read this switch (dynamically, so the interpret-mode monkeypatch
#: below reaches every path).  The sharding specs are verified
#: statically: psum/pmin outputs are typed invariant, per-shard values
#: varying, and an out_spec claiming replication of a varying value is
#: a trace-time error (see utils/vma.py for the carry-promotion
#: helper).  Tests running the grouped Pallas QP in INTERPRET mode
#: flip this off: the pallas HLO interpreter itself trips the vma
#: rules on its internal block slicing (JAX suggests check_vma=False
#: as the workaround for exactly this); the compiled GPU kernel is
#: unaffected.
CHECK_VMA = True



def _weights_backend_kwargs(weights_solver_kwargs, k=None):
    """Resolve the weights-QP backend + kwargs for the sharded paths.

    The restart-batched QP dispatches through
    ``quad_simplex_spg_batch_grouped``: 'xla' vmaps the lockstep
    solver, 'pallas' runs all restarts in one fused grouped kernel
    (ops/pallas_qp.py:quad_simplex_qp_pallas).  'auto' resolves with
    sharded-fit semantics (solvers.spg.resolve_qp_backend has the
    measured numbers); an unknown backend raises ``ValueError``."""
    cfg = make_config(QPSolverConfig, weights_solver_kwargs)
    backend = resolve_qp_backend(cfg.backend, k=k, regime='sharded_fit')
    return backend, cfg.kwargs()


@apply_matmul_precision
def distributed_gram(mesh, X, feature_axis="samples"):
    """Gram matrix ``X X'`` with the feature dimension sharded.

    Each device forms the partial Gram of its feature block; one
    ``psum`` accumulates them (blockwise Gram formation —
    the sharded analog of reference archetypal_analysis.py:1032).
    """
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=P(None, feature_axis), out_specs=P())
    def _gram(X_loc):
        return jax.lax.psum(X_loc @ X_loc.T, feature_axis)

    return _gram(X)


# ---------------------------------------------------------------------------
# Shared per-iteration math (one AA alternating iteration on local shards)
# ---------------------------------------------------------------------------


def _aa_pre_weights(X_loc, K_loc, Z_loc, C, alpha, *, delta, do_scale,
                    dict_kwargs, scale_kwargs, sample_axis):
    """Scale-factor and dictionary updates of one AA iteration plus the
    weights-QP operands (everything before the weights solve).

    Mirrors the update order and factorization of the single-device core
    (models/archetypal_analysis._kernel_aa_core body: scale factors →
    dictionary → weights QP operands), with the k-sized contractions
    crossing sample shards via ``psum``/``all_gather``.  ``X_loc`` is
    unused here (the split exists so the weights QP can batch across
    restarts — see :func:`_aa_iterate_batch`).
    """
    n_loc = K_loc.shape[0]
    n_samples = C.shape[1]
    shard = jax.lax.axis_index(sample_axis)

    def cols(M):
        return jax.lax.dynamic_slice_in_dim(M, shard * n_loc, n_loc, axis=1)

    ZtZ = jax.lax.psum(Z_loc.T @ Z_loc, sample_axis)
    Z_full = jax.lax.all_gather(Z_loc, sample_axis, tiled=True)
    KZ_loc = K_loc @ Z_full                          # (n_loc, k)
    CK = jax.lax.psum(cols(C) @ K_loc, sample_axis)  # (k, n) replicated

    if do_scale:
        CKZ = jax.lax.psum(cols(CK) @ Z_loc, sample_axis)
        CKCt = CK @ C.T
        M = ZtZ * CKCt
        project = lambda a: jnp.clip(a, 1.0 - delta, 1.0 + delta)
        alpha = quad_spg(lambda a: (M @ a) / n_samples,
                         jnp.diagonal(CKZ) / n_samples, alpha, project,
                         **scale_kwargs)

    # --- dictionary update (distributed quad_spg; parity with
    # update_kernel_aa_dictionary) ---
    KZD_loc = KZ_loc * alpha[None, :]
    # Assemble the full (n, k) KZD by psum-of-scattered-blocks rather
    # than all_gather: numerically identical (zeros elsewhere), but
    # psum output is typed INVARIANT over the sample axis, which the
    # static vma checker needs — the dictionary iterate stays
    # replicated within each sample group and the final best-C output
    # can be claimed P() (all_gather output stays typed varying).
    KZD_full = jax.lax.psum(
        jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros((n_samples, KZD_loc.shape[1]), KZD_loc.dtype),
            KZD_loc, shard * n_loc, axis=0),
        sample_axis)
    B = KZD_full.T / n_samples
    DZtZD = (alpha[:, None] * ZtZ) * alpha[None, :]

    def matvec(Cm):
        CKm = jax.lax.psum(cols(Cm) @ K_loc, sample_axis)
        return DZtZD @ CKm / n_samples

    C = quad_spg(matvec, B, C, simplex_project_rows, **dict_kwargs)

    # --- weights-QP operands (parity with update_kernel_aa_weights) ---
    CK = jax.lax.psum(cols(C) @ K_loc, sample_axis)
    CKCt = CK @ C.T
    A = (alpha[:, None] * CKCt) * alpha[None, :]
    B_w = -(alpha[:, None] * cols(CK)).T             # (n_loc, k)
    return C, alpha, A, B_w, CK, CKCt


def _aa_iter_cost(X_loc, Z_loc, C, alpha, CK, CKCt, trace_K, sample_axis):
    """Post-weights cost of one AA iteration: explicit residual when a
    data matrix is available, kernel trace form otherwise."""
    n_loc = Z_loc.shape[0]
    n_samples = C.shape[1]
    shard = jax.lax.axis_index(sample_axis)

    def cols(M):
        return jax.lax.dynamic_slice_in_dim(M, shard * n_loc, n_loc, axis=1)

    if X_loc is not None:
        # --- residual cost (the _kernel_aa_core has_data form) ---
        CX = jax.lax.psum(cols(C) @ X_loc, sample_axis)  # (k, d)
        resid = Z_loc @ (alpha[:, None] * CX) - X_loc
        return jax.lax.psum(jnp.sum(resid * resid), sample_axis) \
            * 0.5 / n_samples
    # --- kernel trace form (no data matrix available) ---
    CKZ = jax.lax.psum(cols(CK) @ Z_loc, sample_axis)
    ZtZ_new = jax.lax.psum(Z_loc.T @ Z_loc, sample_axis)
    return _cost_from_parts(trace_K, CKZ, ZtZ_new, CKCt, alpha, n_samples)


def _aa_iterate_batch(X_loc, K_loc, *, delta, do_scale, dict_kwargs,
                      weights_backend, weights_kwargs, scale_kwargs,
                      sample_axis, trace_K=None):
    """Build the restart-batched AA iterate for :func:`_keep_best_loop`.

    The scale/dictionary updates vmap over the local restart axis; the
    weights QP batches across restarts through
    :func:`solvers.spg.quad_simplex_spg_batch_grouped`, so
    ``weights_backend='pallas'`` runs ALL restarts' row QPs in one
    fused grouped kernel (a plain vmap over the single-Hessian kernel
    cannot nest).
    """
    def pre(Z, C, a):
        return _aa_pre_weights(
            X_loc, K_loc, Z, C, a, delta=delta, do_scale=do_scale,
            dict_kwargs=dict_kwargs, scale_kwargs=scale_kwargs,
            sample_axis=sample_axis)

    def cost_of(Z, C, a, CK, CKCt):
        return _aa_iter_cost(X_loc, Z, C, a, CK, CKCt, trace_K,
                             sample_axis)

    def iterate_batch(Zs, Cs, alphas):
        Cs, alphas, As, Bws, CKs, CKCts = jax.vmap(pre)(Zs, Cs, alphas)
        Zs = quad_simplex_spg_batch_grouped(
            As, Bws, Zs, backend=weights_backend, **weights_kwargs)
        costs = jax.vmap(cost_of)(Zs, Cs, alphas, CKs, CKCts)
        return Zs, Cs, alphas, costs

    return iterate_batch


def _aa_local_cost(X_loc, Z_loc, C, alpha, sample_axis):
    n_loc = X_loc.shape[0]
    n_samples = C.shape[1]
    shard = jax.lax.axis_index(sample_axis)
    C_cols = jax.lax.dynamic_slice_in_dim(C, shard * n_loc, n_loc, axis=1)
    CX = jax.lax.psum(C_cols @ X_loc, sample_axis)
    resid = Z_loc @ (alpha[:, None] * CX) - X_loc
    return jax.lax.psum(jnp.sum(resid * resid), sample_axis) \
        * 0.5 / n_samples


def _kernel_aa_local_cost(K_loc, Z_loc, C, alpha, trace_K, sample_axis):
    """Kernel trace-form cost from a row-sharded kernel."""
    n_loc = K_loc.shape[0]
    n_samples = C.shape[1]
    shard = jax.lax.axis_index(sample_axis)

    def cols(M):
        return jax.lax.dynamic_slice_in_dim(M, shard * n_loc, n_loc, axis=1)

    CK = jax.lax.psum(cols(C) @ K_loc, sample_axis)
    CKZ = jax.lax.psum(cols(CK) @ Z_loc, sample_axis)
    CKCt = CK @ C.T
    ZtZ = jax.lax.psum(Z_loc.T @ Z_loc, sample_axis)
    return _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples)


# ---------------------------------------------------------------------------
# Keep-best convergence machinery (shared by the AA and GPNH fits)
# ---------------------------------------------------------------------------


def _keep_best_loop(states, cost0, iterate_batch, *, tolerance, criterion,
                    max_iterations):
    """Run batched local restarts to convergence with per-restart
    freezing.  ``states`` is a pytree with a leading local-restart axis;
    ``iterate_batch(*leaves) -> (*leaves, costs)`` advances the whole
    restart batch one alternating iteration (typically built by
    :func:`_aa_iterate_batch`, or an inline ``jax.vmap``)."""
    R_loc = cost0.shape[0]
    trace = jnp.zeros((R_loc, max_iterations), cost0.dtype)
    n_iters = jnp.zeros((R_loc,), jnp.int32)
    done0 = jnp.zeros((R_loc,), bool)

    def cond(carry):
        states, cost, it, done, trace, n_iters = carry
        return (~jnp.all(done)) & (it < max_iterations)

    def body(carry):
        states, cost, it, done, trace, n_iters = carry
        out = iterate_batch(*states)
        new_states, new_cost = tuple(out[:-1]), out[-1]
        # Converged restarts freeze (lockstep, like the vmapped
        # single-chip batch); the rest advance.
        new_states = tuple(
            jnp.where(done.reshape((-1,) + (1,) * (n.ndim - 1)), o, n)
            for o, n in zip(states, new_states))
        new_cost = jnp.where(done, cost, new_cost)
        trace = trace.at[:, it].set(jnp.where(done, 0.0, new_cost - cost))
        n_iters = n_iters + (~done).astype(jnp.int32)
        done = done | has_converged(cost, new_cost, tolerance, criterion)
        return new_states, new_cost, it + 1, done, trace, n_iters

    init = (tuple(states), cost0, jnp.asarray(0, jnp.int32), done0,
            trace, n_iters)
    # vma promotion for shard_map(check_vma=CHECK_VMA): the scheduler
    # constants (iteration counter, done flags, traces) inherit the
    # restart axis' varying type from cost0 in the loop body — and so
    # do the states themselves (a constant-initialized state leaf, e.g.
    # alpha = ones with the scale update off, becomes varying through
    # the per-restart freeze select).  No-op outside shard_map
    # (see utils/vma.py).
    init = (pvary_like(init[0], cost0), cost0) + pvary_like(
        init[2:], cost0)
    states, cost, it, done, trace, n_iters = jax.lax.while_loop(
        cond, body, init)
    return states, cost, trace, n_iters, done


def _select_best(states, costs, trace, n_iters, *, n_valid, restart_axis):
    """Cross-mesh keep-best: mask padded restarts, local argmin, then a
    global argmin over the restart axis with a psum-based broadcast of
    the winning state (small: the state is one restart's factors)."""
    R_loc = costs.shape[0]
    r_group = jax.lax.axis_index(restart_axis)
    global_idx = r_group * R_loc + jnp.arange(R_loc)
    masked = jnp.where(global_idx < n_valid, costs, jnp.inf)

    local_best = jnp.argmin(masked)
    local_cost = masked[local_best]
    # Cross-mesh argmin via pmin reductions (outputs typed invariant
    # over the restart axis — an all_gather + argmin computes the same
    # winner but stays typed varying, failing the static vma check on
    # the replicated P() outputs).  Ties break to the lowest restart
    # group, matching argmin-over-gather semantics.
    best_cost = jax.lax.pmin(local_cost, restart_axis)
    winner_group = jax.lax.pmin(
        jnp.where(local_cost == best_cost, r_group,
                  jnp.iinfo(jnp.int32).max),
        restart_axis)
    is_winner = (r_group == winner_group)

    def pick(arr):
        cand = arr[local_best]
        return jax.lax.psum(
            jnp.where(is_winner, cand, jnp.zeros_like(cand)), restart_axis)

    best_states = tuple(pick(s) for s in states)
    best_trace = pick(trace)
    best_n_iter = pick(n_iters)
    return best_states, best_cost, best_n_iter, best_trace


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


@apply_matmul_precision
def sharded_aa_train_step(mesh, X, Zs, Cs, alphas, *, delta=0.0,
                          do_scale=False,
                          dict_iterations=5, weights_iterations=50,
                          weights_backend='auto',
                          restart_axis="restarts", sample_axis="samples"):
    """One full AA alternating iteration over a 2-D mesh.

    Arguments:
      X:      (n_samples, n_features), rows sharded over ``sample_axis``.
      Zs:     (n_restarts, n_samples, k) — restarts over ``restart_axis``,
              sample rows over ``sample_axis``.
      Cs:     (n_restarts, k, n_samples) — restarts sharded, replicated
              within a sample group.
      alphas: (n_restarts, k); updated when ``do_scale`` (box [1±delta]).

    ``weights_backend='pallas'`` runs the restart-batched weight QPs in
    one fused grouped kernel; the default 'auto' picks it on the GPU
    (see ``solvers.spg.resolve_qp_backend``).  Returns updated ``(Zs, Cs,
    alphas, costs)`` with the same shardings (``costs``: per-restart
    objective).  Jit-compatible; call under ``jax.jit`` for real runs.
    """
    weights_backend = resolve_qp_backend(
        weights_backend, k=Zs.shape[-1], regime='sharded_fit')
    dict_kwargs = _spg_cfg_to_quad_kwargs(
        SPGSolverConfig(max_iterations=dict_iterations))
    weights_kwargs = QPSolverConfig(
        max_iterations=weights_iterations).kwargs()
    scale_kwargs = _spg_cfg_to_quad_kwargs(SPGSolverConfig())

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(sample_axis, None),
                  P(restart_axis, sample_axis, None),
                  P(restart_axis, None, None),
                  P(restart_axis, None)),
        out_specs=(P(restart_axis, sample_axis, None),
                   P(restart_axis, None, None),
                   P(restart_axis, None),
                   P(restart_axis)),
        check_vma=CHECK_VMA)
    def step(X_loc, Zs_loc, Cs_loc, alphas_loc):
        X_full = jax.lax.all_gather(X_loc, sample_axis, tiled=True)
        K_loc = X_loc @ X_full.T

        iterate_batch = _aa_iterate_batch(
            X_loc, K_loc, delta=delta, do_scale=do_scale,
            dict_kwargs=dict_kwargs, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
            sample_axis=sample_axis)
        return iterate_batch(Zs_loc, Cs_loc, alphas_loc)

    return step(X, Zs, Cs, alphas)


@apply_matmul_precision
def sharded_aa_fit(mesh, X, Zs, Cs, alphas, *, delta=0.0, tolerance=1e-6,
                   max_iterations=100, stopping_criterion='abs_delta_f',
                   dictionary_solver_kwargs=None,
                   weights_solver_kwargs=None,
                   scale_factors_solver_kwargs=None,
                   n_valid_restarts=None,
                   restart_axis="restarts", sample_axis="samples"):
    """Full sharded AA fit to convergence with cross-mesh keep-best.

    Same state layout as :func:`sharded_aa_train_step`.  Each restart
    runs the alternating loop until its ``stopping_criterion`` delta
    falls below ``tolerance`` (converged restarts freeze while the rest
    continue, as in the vmapped single-chip batch); the final selection
    masks restarts with global index >= ``n_valid_restarts`` (padding
    added for mesh divisibility) and broadcasts the winner.

    Returns a dict with the best restart's ``weights`` (sharded over
    samples), ``dictionary``, ``alpha``, ``cost``, ``n_iter``,
    ``cost_deltas``, plus per-restart ``costs``/``n_iters`` (sharded
    over restarts).  The mathematics per iteration matches the
    single-device ``_kernel_aa_core``, so cost trajectories agree with
    the unsharded fit up to reduction-order rounding.
    """
    n_restarts = Zs.shape[0]
    if n_valid_restarts is None:
        n_valid_restarts = n_restarts
    do_scale = float(delta) != 0.0

    dict_kwargs = _spg_cfg_to_quad_kwargs(
        make_config(SPGSolverConfig, dictionary_solver_kwargs))
    weights_backend, weights_kwargs = _weights_backend_kwargs(
        weights_solver_kwargs, k=Zs.shape[-1])
    scale_kwargs = _spg_cfg_to_quad_kwargs(
        make_config(SPGSolverConfig, scale_factors_solver_kwargs))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(sample_axis, None),
                  P(restart_axis, sample_axis, None),
                  P(restart_axis, None, None),
                  P(restart_axis, None)),
        out_specs=(P(sample_axis, None),   # best Z (rows sharded)
                   P(),                    # best C
                   P(),                    # best alpha
                   P(),                    # best cost
                   P(),                    # best n_iter
                   P(),                    # best cost-delta trace
                   P(restart_axis),        # all costs
                   P(restart_axis)),       # all n_iters
        check_vma=CHECK_VMA)
    def fit(X_loc, Zs_loc, Cs_loc, alphas_loc):
        X_full = jax.lax.all_gather(X_loc, sample_axis, tiled=True)
        K_loc = X_loc @ X_full.T

        iterate_batch = _aa_iterate_batch(
            X_loc, K_loc, delta=delta, do_scale=do_scale,
            dict_kwargs=dict_kwargs, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
            sample_axis=sample_axis)

        cost0 = jax.vmap(
            lambda Z, C, a: _aa_local_cost(X_loc, Z, C, a, sample_axis)
        )(Zs_loc, Cs_loc, alphas_loc)

        states, costs, trace, n_iters, _ = _keep_best_loop(
            (Zs_loc, Cs_loc, alphas_loc), cost0, iterate_batch,
            tolerance=tolerance, criterion=stopping_criterion,
            max_iterations=max_iterations)

        best, best_cost, best_n_iter, best_trace = _select_best(
            states, costs, trace, n_iters, n_valid=n_valid_restarts,
            restart_axis=restart_axis)
        Z_best, C_best, alpha_best = best
        return (Z_best, C_best, alpha_best, best_cost, best_n_iter,
                best_trace, costs, n_iters)

    (Z, C, alpha, cost, n_iter, trace, costs, n_iters) = fit(
        X, Zs, Cs, alphas)
    return {
        'weights': Z,
        'dictionary': alpha[:, None] * C if do_scale else C,
        'alpha': alpha,
        'cost': cost,
        'n_iter': n_iter,
        'cost_deltas': trace,
        'costs': costs,
        'n_iters': n_iters,
    }


@apply_matmul_precision
def sharded_kernel_aa_fit(mesh, K, Zs, Cs, alphas, *, delta=0.0,
                          tolerance=1e-6, max_iterations=100,
                          stopping_criterion='abs_delta_f',
                          dictionary_solver_kwargs=None,
                          weights_solver_kwargs=None,
                          scale_factors_solver_kwargs=None,
                          n_valid_restarts=None,
                          restart_axis="restarts",
                          sample_axis="samples"):
    """Full sharded KernelAA fit from a precomputed kernel.

    Same contract as :func:`sharded_aa_fit`, but takes the (n, n)
    kernel ``K`` with ROWS sharded over ``sample_axis`` instead of the
    data matrix (the reference ``KernelAA`` surface,
    archetypal_analysis.py:673-910).  The convergence cost uses the
    kernel trace form (models/archetypal_analysis.kernel_aa_cost); the
    update math is identical.  ``K`` from sharded data can be formed
    with :func:`distributed_gram`.
    """
    n_restarts = Zs.shape[0]
    if n_valid_restarts is None:
        n_valid_restarts = n_restarts
    do_scale = float(delta) != 0.0

    dict_kwargs = _spg_cfg_to_quad_kwargs(
        make_config(SPGSolverConfig, dictionary_solver_kwargs))
    weights_backend, weights_kwargs = _weights_backend_kwargs(
        weights_solver_kwargs, k=Zs.shape[-1])
    scale_kwargs = _spg_cfg_to_quad_kwargs(
        make_config(SPGSolverConfig, scale_factors_solver_kwargs))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(sample_axis, None),
                  P(restart_axis, sample_axis, None),
                  P(restart_axis, None, None),
                  P(restart_axis, None)),
        out_specs=(P(sample_axis, None),   # best Z (rows sharded)
                   P(),                    # best C
                   P(),                    # best alpha
                   P(),                    # best cost
                   P(),                    # best n_iter
                   P(),                    # best cost-delta trace
                   P(restart_axis),        # all costs
                   P(restart_axis)),       # all n_iters
        check_vma=CHECK_VMA)
    def fit(K_loc, Zs_loc, Cs_loc, alphas_loc):
        n_loc = K_loc.shape[0]
        shard = jax.lax.axis_index(sample_axis)
        diag_block = jax.lax.dynamic_slice_in_dim(
            K_loc, shard * n_loc, n_loc, axis=1)
        trace_K = jax.lax.psum(jnp.trace(diag_block), sample_axis)

        iterate_batch = _aa_iterate_batch(
            None, K_loc, delta=delta, do_scale=do_scale,
            dict_kwargs=dict_kwargs, weights_backend=weights_backend,
            weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
            sample_axis=sample_axis, trace_K=trace_K)

        cost0 = jax.vmap(
            lambda Z, C, a: _kernel_aa_local_cost(
                K_loc, Z, C, a, trace_K, sample_axis)
        )(Zs_loc, Cs_loc, alphas_loc)

        states, costs, trace, n_iters, _ = _keep_best_loop(
            (Zs_loc, Cs_loc, alphas_loc), cost0, iterate_batch,
            tolerance=tolerance, criterion=stopping_criterion,
            max_iterations=max_iterations)

        best, best_cost, best_n_iter, best_trace = _select_best(
            states, costs, trace, n_iters, n_valid=n_valid_restarts,
            restart_axis=restart_axis)
        Z_best, C_best, alpha_best = best
        return (Z_best, C_best, alpha_best, best_cost, best_n_iter,
                best_trace, costs, n_iters)

    (Z, C, alpha, cost, n_iter, trace, costs, n_iters) = fit(
        K, Zs, Cs, alphas)
    return {
        'weights': Z,
        'dictionary': alpha[:, None] * C if do_scale else C,
        'alpha': alpha,
        'cost': cost,
        'n_iter': n_iter,
        'cost_deltas': trace,
        'costs': costs,
        'n_iters': n_iters,
    }


@apply_matmul_precision
def sharded_gpnh_fit(mesh, X, Zs, Ws, *, lambda_W=0.0, tolerance=1e-6,
                     max_iterations=100, stopping_criterion='abs_delta_f',
                     weights_solver_kwargs=None, n_valid_restarts=None,
                     restart_axis="restarts", sample_axis="samples"):
    """Full sharded GPNH convex-coding fit with cross-mesh keep-best.

    State layout: ``X`` (n, d) rows sharded over ``sample_axis``;
    ``Zs`` (R, n, k) sharded over (restarts, samples); ``Ws`` (R, d, k)
    sharded over restarts, replicated within a sample group.  Mirrors
    the single-device ``_gpnh_core`` updates: exact k x k lstsq
    dictionary solve on psum'd ``Z'Z``/``Z'X``, local per-row simplex-QP
    weights, residual cost + GPNH penalty.
    """
    from ..models.gpnh_convex_coding import _gpnh_gram, gpnh_regularization

    n_restarts = Zs.shape[0]
    if n_valid_restarts is None:
        n_valid_restarts = n_restarts
    weights_backend, weights_kwargs = _weights_backend_kwargs(
        weights_solver_kwargs, k=Zs.shape[-1])

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(sample_axis, None),
                  P(restart_axis, sample_axis, None),
                  P(restart_axis, None, None)),
        out_specs=(P(sample_axis, None),   # best Z
                   P(),                    # best W
                   P(),                    # best cost
                   P(),                    # best n_iter
                   P(),                    # best trace
                   P(restart_axis),        # all costs
                   P(restart_axis)),       # all n_iters
        check_vma=CHECK_VMA)
    def fit(X_loc, Zs_loc, Ws_loc):
        n_loc, d = X_loc.shape
        k = Ws_loc.shape[2]
        n_samples = jax.lax.psum(n_loc, sample_axis)
        GW = _gpnh_gram(d, k, X_loc.dtype)

        def penalty(W):
            return jnp.where(lambda_W != 0,
                             lambda_W * gpnh_regularization(W), 0.0)

        def cost_of(Z_loc, W):
            resid = Z_loc @ W.T - X_loc
            return (jax.lax.psum(jnp.sum(resid * resid), sample_axis)
                    * 0.5 / n_samples + penalty(W))

        def dict_update(Z_loc):
            # dictionary: (Z'Z/n + lambda_W G_W) W' = Z'X/n, replicated
            ZtZ = jax.lax.psum(Z_loc.T @ Z_loc, sample_axis)
            ZtX = jax.lax.psum(Z_loc.T @ X_loc, sample_axis)
            lhs = ZtZ / n_samples + lambda_W * GW
            W = jnp.linalg.lstsq(lhs, ZtX / n_samples)[0].T
            return W, W.T @ W, -(X_loc @ W)

        def iterate_batch(Zs_l, Ws_l):
            # dictionary per restart; weights QPs grouped across
            # restarts (pallas backend runs them in one fused kernel).
            Ws_l, WtWs, Bs = jax.vmap(dict_update)(Zs_l)
            Zs_l = quad_simplex_spg_batch_grouped(
                WtWs, Bs, Zs_l, backend=weights_backend,
                **weights_kwargs)
            costs = jax.vmap(cost_of)(Zs_l, Ws_l)
            return Zs_l, Ws_l, costs

        cost0 = jax.vmap(cost_of)(Zs_loc, Ws_loc)
        states, costs, trace, n_iters, _ = _keep_best_loop(
            (Zs_loc, Ws_loc), cost0, iterate_batch, tolerance=tolerance,
            criterion=stopping_criterion, max_iterations=max_iterations)

        best, best_cost, best_n_iter, best_trace = _select_best(
            states, costs, trace, n_iters, n_valid=n_valid_restarts,
            restart_axis=restart_axis)
        Z_best, W_best = best
        return (Z_best, W_best, best_cost, best_n_iter, best_trace,
                costs, n_iters)

    Z, W, cost, n_iter, trace, costs, n_iters = fit(X, Zs, Ws)
    return {
        'weights': Z,
        'dictionary': W,
        'cost': cost,
        'n_iter': n_iter,
        'cost_deltas': trace,
        'costs': costs,
        'n_iters': n_iters,
    }
