"""Archetypal analysis (standard and kernelized) on the JAX core.

Re-implements the reference's alternating-minimization AA
(reference: src/convex_dim_red/archetypal_analysis.py) as a single
jit-compiled ``lax.while_loop``: per outer iteration an optional
box-constrained SPG update of the scale factors ``alpha``, an SPG update
of the row-stochastic dictionary ``C``, and a batched simplex-QP update
of the row-stochastic weights ``Z`` (all rows solved in lockstep as
batched matmuls).  The whole fit — including convergence testing and the
monotonicity watchdog — runs on device; the host sees only the final
state plus diagnostics.

Design choices (same mathematics, different factorization of the
work):

- ``ArchetypalAnalysis`` forms the Gram matrix ``K = X X'`` once (one
  matmul) and runs the *kernel* iteration, instead of re-contracting
  against ``X`` inside every dictionary line-search step as the
  reference's data-space ``_iterate_aa`` does
  (archetypal_analysis.py:534-670).  For ``n_features > n_samples``
  (every case study in the reference) this strictly reduces FLOPs; the
  objective, gradients, and iterates are mathematically identical.
- The SPG objectives drop constant terms (``trace K``) so float32 line
  searches compare differences that are actually representable; the
  reported cost adds the constant back in float64 scalar arithmetic
  (see ``_scalar_dtype``).
- Objective normalization is uniformly ``1/n_samples``.  (The reference
  divides some sub-objectives by ``n_components`` instead —
  archetypal_analysis.py:265,277 vs :297 — which rescales the SPG
  objective without changing its minimizer; we use the consistent
  scaling.)
- The monotonicity watchdog (reference ``_check_if_cost_increased``,
  archetypal_analysis.py:167-174) cannot raise mid-jit; per-stage
  increase flags are accumulated in the carry, stop the loop, and are
  raised host-side after the fact.

The public functional API (``kernel_aa_cost``,
``update_kernel_aa_dictionary``, ``update_kernel_aa_weights``,
``update_kernel_aa_scale_factors``, ``iterate_kernel_aa``) mirrors the
reference's module-level functions so its property tests port directly;
``KernelAA`` / ``ArchetypalAnalysis`` mirror the estimator API
(archetypal_analysis.py:673-1215).
"""

import functools
import numbers
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.furthest_sum import furthest_sum, dissimilarities_from_kernel
from ..ops.simplex_projection import simplex_project_rows
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..solvers.spg import (quad_spg, quad_simplex_spg_batch,
                           resolve_qp_backend)
from ..utils.precision import apply_matmul_precision, matmul_precision_scope
from ..utils.validation import check_array_shape, check_stochastic_matrix
from ..utils.vma import pvary_like
from ._common import (QPSolverConfig, SPGSolverConfig, make_config,
                      STOPPING_CRITERIA, has_converged,
                      prepare_estimator_mesh)

__all__ = [
    "KernelAA",
    "ArchetypalAnalysis",
    "kernel_aa_cost",
    "update_kernel_aa_dictionary",
    "update_kernel_aa_weights",
    "update_kernel_aa_scale_factors",
    "iterate_kernel_aa",
]

INITIALIZATION_METHODS = (None, 'random', 'furthest_sum', 'custom')


def _scalar_dtype(dtype):
    """Dtype for cost/convergence scalars: float64 when x64 is enabled
    (tiny k x k reductions, negligible in float64),
    else the working dtype."""
    if jax.config.jax_enable_x64:
        return jnp.float64
    return dtype


def _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples):
    """AA objective 0.5 (tr K - 2 tr(D CKZ) + tr(D Z'Z D CKC'))/n.

    Parity with the reference's trace form (archetypal_analysis.py:200-217)
    computed from the small k x k intermediates in scalar precision.
    """
    sdt = _scalar_dtype(CKZ.dtype)
    a = alpha.astype(sdt)
    tr_dckz = jnp.sum(a * jnp.diagonal(CKZ).astype(sdt))
    dzzd = (a[:, None] * ZtZ.astype(sdt)) * a[None, :]
    tr_quad = jnp.sum(dzzd * CKCt.astype(sdt).T)
    return 0.5 * (trace_K.astype(sdt) - 2.0 * tr_dckz + tr_quad) / n_samples


def kernel_aa_cost(K, weights, dictionary, alpha):
    """Evaluate the kernel-AA cost ``0.5||X - a Z C X||^2_F / n`` in
    kernel form.  Parity with reference ``_kernel_aa_cost``
    (archetypal_analysis.py:200-217)."""
    K = jnp.asarray(K)
    Z = jnp.asarray(weights)
    C = jnp.asarray(dictionary)
    alpha = jnp.asarray(alpha)
    n = K.shape[0]
    CK = C @ K
    CKZ = CK @ Z
    CKCt = CK @ C.T
    ZtZ = Z.T @ Z
    trace_K = jnp.trace(K)
    return _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n)


def _spg_cfg_to_quad_kwargs(cfg):
    """Map an :class:`SPGSolverConfig` onto :func:`quad_spg` arguments.

    The nonmonotone line-search parameters have no counterpart: the AA
    subproblems are exact quadratics, so the solver minimizes each line
    segment in closed form (see solvers/spg.py:quad_spg).
    """
    alpha0 = cfg.alpha0 if cfg.alpha0 is not None else -1.0
    return dict(alpha0=alpha0, alpha_min=cfg.alpha_min,
                alpha_max=cfg.alpha_max, epsilon_one=cfg.epsilon_one,
                epsilon_two=cfg.epsilon_two,
                max_iterations=cfg.max_iterations)


def update_kernel_aa_dictionary(K, dictionary, alpha, trace_K, KZ, ZtZ,
                                **solver_kwargs):
    """SPG solve of the dictionary subproblem (rows on the simplex).

    Parity with reference ``_update_kernel_aa_dictionary``
    (archetypal_analysis.py:304-321): minimizes
    ``0.5 tr(DZ'ZD C K C')/n - tr(C KZD)/n`` over row-stochastic ``C``.
    The subproblem is an exact QP in ``C`` with Hessian action
    ``H(C) = DZ'ZD @ C @ K / n``, so it is solved with the closed-form
    line-search SPG (:func:`quad_spg`) — one ``H`` application per
    iteration instead of the reference's repeated ``C @ K`` cost
    evaluations inside the Armijo backtracking.  ``trace_K`` is accepted
    for signature parity (constant term; irrelevant to the minimizer).
    """
    del trace_K
    cfg = make_config(SPGSolverConfig, solver_kwargs)
    K = jnp.asarray(K)
    C = jnp.asarray(dictionary)
    alpha = jnp.asarray(alpha)
    KZ = jnp.asarray(KZ)
    ZtZ = jnp.asarray(ZtZ)

    n_samples = K.shape[0]
    KZD = KZ * alpha[None, :]
    DZtZD = (alpha[:, None] * ZtZ) * alpha[None, :]

    matvec = lambda C: DZtZD @ (C @ K) / n_samples
    B = KZD.T / n_samples
    return quad_spg(matvec, B, C, simplex_project_rows,
                    **_spg_cfg_to_quad_kwargs(cfg))


def update_kernel_aa_weights(weights, alpha, CK, CKCt,
                             component_mask=None, **solver_kwargs):
    """Batched simplex-QP update of the weights.

    Parity with reference ``_update_kernel_aa_weights``
    (archetypal_analysis.py:369-396): per row ``t`` solve
    ``min 1/2 z' (D CKC' D) z - (D CK)[:, t]' z`` on the simplex.

    ``component_mask`` (optional (k,) bool, runtime value) restricts
    every row to the masked sub-simplex — padded components stay
    exactly zero (see ``solvers.spg.quad_simplex_spg``).
    """
    cfg = make_config(QPSolverConfig, solver_kwargs)
    Z = jnp.asarray(weights)
    alpha = jnp.asarray(alpha)
    CK = jnp.asarray(CK)
    CKCt = jnp.asarray(CKCt)

    A = (alpha[:, None] * CKCt) * alpha[None, :]
    B = -(alpha[:, None] * CK).T
    return quad_simplex_spg_batch(A, B, Z, backend=cfg.backend,
                                  mask=component_mask, **cfg.kwargs())


def update_kernel_aa_scale_factors(alpha, trace_K, CKZ, ZtZ, CKCt, delta,
                                   **solver_kwargs):
    """Box-constrained SPG update of the scale factors.

    Parity with reference ``_update_kernel_aa_scale_factors``
    (archetypal_analysis.py:243-258).
    """
    cfg = make_config(SPGSolverConfig, solver_kwargs)
    alpha = jnp.asarray(alpha)
    CKZ = jnp.asarray(CKZ)
    ZtZ = jnp.asarray(ZtZ)
    CKCt = jnp.asarray(CKCt)

    n_samples = CKZ.shape[1] if CKZ.ndim == 2 else CKZ.shape[0]
    diag_ckz = jnp.diagonal(CKZ)
    M = ZtZ * CKCt  # symmetric PSD (Schur product of PSD matrices)

    def project(a):
        return jnp.clip(a, 1.0 - delta, 1.0 + delta)

    matvec = lambda a: (M @ a) / n_samples
    B = diag_ckz / n_samples
    return quad_spg(matvec, B, alpha, project,
                    **_spg_cfg_to_quad_kwargs(cfg))


@apply_matmul_precision
@functools.partial(
    jax.jit,
    static_argnames=('do_scale', 'do_dict', 'do_weights', 'criterion',
                     'max_iterations', 'require_monotonic', 'has_data',
                     'dict_cfg', 'weights_cfg', 'scale_cfg'))
def _kernel_aa_core(K, Z, C, alpha, delta, tolerance, X,
                    component_mask=None, *,
                    do_scale, do_dict, do_weights, criterion,
                    max_iterations, require_monotonic, has_data,
                    dict_cfg, weights_cfg, scale_cfg):
    """Whole alternating fit as one on-device while loop.

    ``component_mask`` (optional (k,) bool, a runtime value) runs a
    padded-``k`` fit: masked-out components are pinned to zero weight,
    so the trajectory equals the unpadded fit with the same active
    initialization exactly (padded dictionary rows receive zero
    gradient because their weight columns are zero, and contribute
    nothing to any cost term).  ``Z``'s padded columns must be zero on
    entry.  This lets one compiled program serve a bucket of component
    counts (see ``parallel.sweep.aa_model_selection_sweep``).

    When the data matrix ``X`` is available (``has_data``; the
    ``ArchetypalAnalysis`` path), the outer-loop cost is evaluated from
    the explicit reconstruction residual ``Z diag(alpha) C X - X`` — a
    sum of squares with no cancellation, so convergence tests and the
    monotonicity watchdog are reliable in float32.  (The kernel trace
    form subtracts O(tr K) quantities that agree to the cost value;
    in float32 that cancellation leaves ~eps * tr(K)/n of noise —
    measured sign-flipping cost estimates on planted data.)  Kernel-only
    fits (``KernelAA``) necessarily use the trace form.
    """
    n_samples = K.shape[0]
    sdt = _scalar_dtype(K.dtype)
    trace_K = jnp.trace(K, dtype=sdt)

    ZtZ = Z.T @ Z
    KZ = K @ Z
    CK = C @ K
    CKCt = CK @ C.T
    CKZ = C @ KZ
    CX = C @ X if has_data else jnp.zeros((), K.dtype)

    def cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX):
        if has_data:
            resid = Z @ (alpha[:, None] * CX) - X
            return (0.5 * jnp.sum(resid * resid) / n_samples).astype(sdt)
        return _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples)

    new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
    tolerance = jnp.asarray(tolerance, dtype=sdt)

    # At least length 1: a zero-size trace cannot be traced through
    # the loop body's .at[n_iter].set (max_iterations=0 is legal and
    # must return the initial cost).
    cost_trace = jnp.zeros((max(int(max_iterations), 1),), dtype=sdt)
    inc_flags = jnp.zeros((3,), dtype=bool)

    # Each subproblem decreases its *kernel-space model* of the cost;
    # the model agrees with the true cost only up to the rounding of
    # forming K = XX' and the k x k contractions, which accumulates to
    # O(n * eps * tr(K)/n) = O(eps * tr(K)).  Below that resolution a
    # "cost increase" is not certifiable, so the watchdog threshold is
    # floored there (float64: ~1e-14 * tr K, far below any practical
    # tolerance, preserving reference behavior; float32: the honest
    # limit of the arithmetic).  Under reduced matmul precision (the
    # 'bfloat16' policy a user can opt into via set_matmul_precision) a
    # float32 fit at its resolution floor oscillates at the
    # eps_f32 * tr(K) scale with either weights backend, which is
    # contraction noise, not a kernel bug; the multiplier 64 leaves
    # headroom above that while staying far below any genuine
    # divergence.  It is not yet measured on the H100.
    watchdog_floor = 64.0 * float(jnp.finfo(K.dtype).eps) * trace_K
    watchdog_thresh = jnp.maximum(tolerance, watchdog_floor)

    def increased(old, new):
        return (new > old) & (new - old > watchdog_thresh)

    def cond(carry):
        (Z, C, alpha, ZtZ, KZ, CK, CKCt, CKZ, CX,
         old_cost, new_cost, n_iter, stop, cost_trace, inc_flags) = carry
        return (~stop) & (n_iter < max_iterations)

    def body(carry):
        (Z, C, alpha, ZtZ, KZ, CK, CKCt, CKZ, CX,
         old_cost, new_cost, n_iter, stop, cost_trace, inc_flags) = carry

        old_cost = new_cost

        if do_scale:
            alpha = update_kernel_aa_scale_factors(
                alpha, trace_K, CKZ, ZtZ, CKCt, delta, **scale_cfg.kwargs())
            new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
            inc_flags = inc_flags.at[0].set(
                inc_flags[0] | increased(old_cost, new_cost))

        if do_dict:
            C = update_kernel_aa_dictionary(
                K, C, alpha, trace_K, KZ, ZtZ, **dict_cfg.kwargs())
            CK = C @ K
            CKCt = CK @ C.T
            CKZ = C @ KZ
            if has_data:
                CX = C @ X
            new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
            inc_flags = inc_flags.at[1].set(
                inc_flags[1] | increased(old_cost, new_cost))

        if do_weights:
            # backend is excluded from kwargs() and must be re-threaded
            # explicitly or the Pallas routing silently degrades to XLA.
            # 'auto' resolves here with fit-regime semantics: these QPs
            # are warm-started every outer iteration (measured XLA-fast;
            # see solvers.spg.resolve_qp_backend).
            Z = update_kernel_aa_weights(
                Z, alpha, CK, CKCt, component_mask=component_mask,
                backend=resolve_qp_backend(weights_cfg.backend,
                                           regime='fit'),
                **weights_cfg.kwargs())
            ZtZ = Z.T @ Z
            KZ = K @ Z
            CKZ = C @ KZ
            new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
            inc_flags = inc_flags.at[2].set(
                inc_flags[2] | increased(old_cost, new_cost))

        cost_trace = cost_trace.at[n_iter].set(new_cost - old_cost)

        stop = has_converged(old_cost, new_cost, tolerance, criterion)
        if require_monotonic:
            stop = stop | jnp.any(inc_flags)

        return (Z, C, alpha, ZtZ, KZ, CK, CKCt, CKZ, CX,
                old_cost, new_cost, n_iter + 1, stop, cost_trace, inc_flags)

    init = (Z, C, alpha, ZtZ, KZ, CK, CKCt, CKZ, CX,
            new_cost, new_cost, jnp.asarray(0, jnp.int32),
            jnp.asarray(False), cost_trace, inc_flags)
    # vma promotion for shard_map(check_vma=True) restart-sharded
    # callers (parallel/restarts.py mesh runners): the fresh-constant
    # carry entries (iteration counter, stop flag, trace, inc_flags)
    # must carry the state's varying axes or the while_loop types
    # mismatch.  No-op outside shard_map (utils/vma.py).
    init = pvary_like(init, Z, C, alpha)
    (Z, C, alpha, ZtZ, KZ, CK, CKCt, CKZ, CX,
     old_cost, new_cost, n_iter, stop, cost_trace, inc_flags) = (
        jax.lax.while_loop(cond, body, init))

    # ``stop`` distinguishes "criterion (or watchdog) fired" from "hit
    # the iteration cap" — the chunked verbose driver needs it to
    # resume across chunk boundaries without a spurious extra step.
    return Z, C, alpha, new_cost, n_iter, cost_trace, inc_flags, stop


_STAGE_NAMES = ('scale factors', 'dictionary', 'weights')

#: Iterations per bounded device execution in the chunked verbose
#: table (see ``iterate_kernel_aa``): small enough that rows stream out
#: at interactive latency and the chunk wall time is a meaningful
#: per-iteration estimate, large enough that per-dispatch overhead
#: stays amortized.
_VERBOSE_CHUNK = 10


def iterate_kernel_aa(K, weights, dictionary, alpha, delta=0,
                      update_weights=True, update_dictionary=True,
                      update_scale_factors=True, tolerance=1e-6,
                      max_iterations=1000, verbose=0, data=None, **kwargs):
    """Run alternating kernel-AA updates to convergence on device.

    Signature and return tuple mirror the reference ``_iterate_kernel_aa``
    (archetypal_analysis.py:399-531):
    ``(weights, dictionary, alpha, cost, n_iter, avg_time_per_iter,
    cost_deltas)``, where ``n_iter`` counts iterations executed and
    ``avg_time_per_iter`` is measured wall clock over the whole on-device
    fit divided by ``n_iter`` (includes compilation on first call for a
    given shape/config).
    """
    if kwargs.get('stopping_criterion',
                  'abs_delta_f') not in STOPPING_CRITERIA:
        raise ValueError("unsupported stopping criterion '%s'"
                         % kwargs['stopping_criterion'])

    require_monotonic = bool(kwargs.get('require_monotonic_cost_decrease',
                                        True))
    criterion = kwargs.get('stopping_criterion', 'abs_delta_f')
    dict_cfg = make_config(SPGSolverConfig,
                           kwargs.get('dictionary_solver_kwargs'))
    weights_cfg = make_config(QPSolverConfig,
                              kwargs.get('weights_solver_kwargs'))
    scale_cfg = make_config(SPGSolverConfig,
                            kwargs.get('scale_factors_solver_kwargs'))

    K = jnp.asarray(K)
    Z = jnp.asarray(weights)
    C = jnp.asarray(dictionary)
    alpha = jnp.asarray(alpha, dtype=K.dtype)

    do_scale = bool(update_scale_factors) and float(delta) != 0.0
    has_data = data is not None
    X = jnp.asarray(data) if has_data else jnp.zeros((), dtype=K.dtype)

    core = functools.partial(
        _kernel_aa_core,
        do_scale=do_scale, do_dict=bool(update_dictionary),
        do_weights=bool(update_weights), criterion=criterion,
        require_monotonic=require_monotonic, has_data=has_data,
        dict_cfg=dict_cfg, weights_cfg=weights_cfg, scale_cfg=scale_cfg)
    delta_op = jnp.asarray(delta, dtype=K.dtype)

    start = time.perf_counter()
    if verbose:
        # Reference-format iteration table (archetypal_analysis.py:
        # 442-447, :515-522) without per-iteration host callbacks: the
        # fit runs in bounded chunks of iterations, each chunk's
        # (cost, delta) rows are reconstructed from the carried cost
        # trace, and the time column is the
        # chunk's measured wall time amortized per iteration (the
        # compiled loop has no clock).  Chunking is state-resuming and
        # trajectory-identical: each chunk continues from the exact
        # (Z, C, alpha) state, and the carried ``stop`` flag
        # distinguishes convergence from the chunk cap.
        print("*** Kernel AA: n_components = {:d} ***".format(Z.shape[1]))
        print('{:<12s} | {:<13s} | {:<13s} | {:<12s}'.format(
            'Iteration', 'Cost', 'Cost delta', 'Time'))
        print(80 * '-')
        row = '{:12d} | {: 12.6e} | {: 12.6e} | {: 12.6e}'

        chunk = int(min(_VERBOSE_CHUNK, max_iterations))
        n_iter = 0
        stop = False
        deltas_parts = []
        inc_any = np.zeros(3, dtype=bool)
        cost = None
        while not stop and n_iter < int(max_iterations):
            this_chunk = min(chunk, int(max_iterations) - n_iter)
            t0 = time.perf_counter()
            Z, C, alpha, cost, n_it, trace, inc_flags, stop = core(
                K, Z, C, alpha, delta_op, tolerance, X,
                max_iterations=this_chunk)
            cost = jax.block_until_ready(cost)
            dt = time.perf_counter() - t0
            n_it = int(n_it)
            if n_it == 0:
                break
            deltas = np.asarray(trace)[:n_it]
            # cost after in-chunk iteration i: final chunk cost minus
            # the deltas still to come.
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
                K, Z, C, alpha, delta_op, tolerance, X,
                max_iterations=0)[3])
        inc_flags = inc_any
        cost_deltas = (np.concatenate(deltas_parts) if deltas_parts
                       else np.zeros((0,)))
        if stop and not inc_flags.any():
            print('*** Converged at iteration {:d} ***'.format(n_iter))
    else:
        Z, C, alpha, cost, n_iter, cost_trace, inc_flags, _ = core(
            K, Z, C, alpha, delta_op, tolerance, X,
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

    avg_time = elapsed / max(n_iter, 1)

    return Z, C, alpha, cost, n_iter, avg_time, cost_deltas


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _as_key(random_state):
    """Coerce int / None / PRNG key into a jax.random key."""
    if random_state is None:
        return jax.random.PRNGKey(np.random.randint(2 ** 31 - 1))
    if isinstance(random_state, (int, np.integer)):
        return jax.random.PRNGKey(int(random_state))
    if isinstance(random_state, np.random.RandomState):
        return jax.random.PRNGKey(random_state.randint(2 ** 31 - 1))
    return random_state  # assume a jax PRNG key


def initialize_kernel_aa_dictionary(kernel, n_components,
                                    init='furthest_sum', key=None, **kwargs):
    """Dictionary init: one-hot rows of FurthestSum-selected samples, or
    a random right-stochastic matrix (reference
    archetypal_analysis.py:51-134)."""
    n_samples = kernel.shape[0]
    if init is None:
        init = 'furthest_sum'

    if init == 'furthest_sum':
        start_index = kwargs.get('start_index')
        n_extra_steps = kwargs.get('n_extra_steps', 10)
        exclude = kwargs.get('exclude')
        if start_index is None:
            start_index = int(jax.random.randint(key, (), 0, n_samples))
        diss = np.asarray(dissimilarities_from_kernel(jnp.asarray(kernel)))
        selected = furthest_sum(diss, n_components, start_index,
                                exclude, n_extra_steps)
        dictionary = np.zeros((n_components, n_samples),
                              dtype=np.asarray(kernel).dtype)
        dictionary[np.arange(n_components), np.asarray(selected)] = 1
        return jnp.asarray(dictionary)

    if init == 'random':
        return right_stochastic_matrix(
            key, (n_components, n_samples), dtype=jnp.asarray(kernel).dtype)

    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def initialize_kernel_aa_weights(kernel, n_components, init='furthest_sum',
                                 key=None):
    if init in (None, 'furthest_sum', 'random'):
        return right_stochastic_matrix(
            key, (kernel.shape[0], n_components),
            dtype=jnp.asarray(kernel).dtype)
    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def initialize_kernel_aa_scale_factors(n_components, delta=0, key=None,
                                       dtype=jnp.float64):
    if delta != 0:
        return jax.random.uniform(
            key, (n_components,), minval=1 - delta, maxval=1 + delta,
            dtype=jax.dtypes.canonicalize_dtype(dtype))
    return jnp.ones((n_components,),
                    dtype=jax.dtypes.canonicalize_dtype(dtype))


def _check_init_weights(weights, shape, whom):
    check_stochastic_matrix(np.asarray(weights), shape, whom, axis=1)


def _check_init_dictionary(dictionary, shape, whom):
    check_stochastic_matrix(np.asarray(dictionary), shape, whom, axis=1)


def _check_init_scale_factors(alpha, delta, shape, whom):
    check_array_shape(np.asarray(alpha), shape, whom)
    a = np.asarray(alpha)
    if np.any((a < 1 - delta) | (a > 1 + delta)):
        raise ValueError('Initial scale factors infeasible in %s' % whom)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


class KernelAA:
    """Kernel archetypal analysis on a precomputed Gram/kernel matrix.

    API parity with the reference ``KernelAA``
    (archetypal_analysis.py:673-910): same constructor parameters,
    ``fit`` / ``fit_transform``, and fitted attributes ``weights``,
    ``dictionary``, ``alpha``, ``cost``, ``n_iter``,
    ``avg_time_per_iter``, ``cost_deltas``.

    ``random_state`` may be an int seed, ``None``, or a jax PRNG key.

    Extension: ``mesh=`` (a ``jax.sharding.Mesh``, or any 1-D mesh
    — lifted by ``parallel.mesh.ensure_mesh_axes``) runs the fit as an
    explicit SPMD program over the mesh's ``samples`` axis
    (``parallel.sharded_aa.sharded_kernel_aa_fit``): kernel rows and
    the per-row weight QPs stay device-local, the k-sized contractions
    cross shards as collectives.  The sharded path covers the full
    alternating fit (``update_*=False`` sub-fits fall back to the
    single-device core) and reports the kernel trace-form cost; the
    in-loop monotonicity watchdog and ``verbose`` iteration tables are
    single-device-only features.
    """

    def __init__(self, n_components, delta=0, init=None,
                 tolerance=1e-6, max_iterations=1000, verbose=0,
                 random_state=None, mesh=None, **kwargs):
        self.n_components = n_components
        self.delta = delta
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
        self.alpha = None
        self.cost = 0
        self.n_iter = 0
        self.avg_time_per_iter = 0
        self.cost_deltas = None

        self.weights_solver_kwargs = kwargs.get('weights_solver_kwargs', {})
        self.dictionary_solver_kwargs = kwargs.get(
            'dictionary_solver_kwargs', {})
        self.scale_factors_solver_kwargs = kwargs.get(
            'scale_factors_solver_kwargs', {})

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

    def _prepare_state(self, kernel, dictionary, weights, alpha,
                       update_dictionary, update_weights, whom, **kwargs):
        n_samples = kernel.shape[0]
        k = self.n_components

        if self.init == 'custom':
            _check_init_weights(weights, (n_samples, k), whom)
            _check_init_dictionary(dictionary, (k, n_samples), whom)
            if alpha is not None:
                _check_init_scale_factors(alpha, self.delta, (k,), whom)
        elif not update_dictionary and update_weights:
            _check_init_dictionary(dictionary, (k, n_samples), whom)
            weights = initialize_kernel_aa_weights(
                kernel, k, init=self.init, key=self._next_key())
        elif update_dictionary and not update_weights:
            _check_init_weights(weights, (n_samples, k), whom)
            dictionary = initialize_kernel_aa_dictionary(
                kernel, k, init=self.init, key=self._next_key(), **kwargs)
        else:
            dictionary = initialize_kernel_aa_dictionary(
                kernel, k, init=self.init, key=self._next_key(), **kwargs)
            weights = initialize_kernel_aa_weights(
                kernel, k, init=self.init, key=self._next_key())

        if alpha is None:
            alpha = initialize_kernel_aa_scale_factors(
                k, delta=self.delta, key=self._next_key(),
                dtype=jnp.asarray(kernel).dtype)
        else:
            _check_init_scale_factors(alpha, self.delta, (k,), whom)

        return jnp.asarray(dictionary), jnp.asarray(weights), \
            jnp.asarray(alpha)

    def _kernel_aa(self, kernel, dictionary=None, weights=None, alpha=None,
                   update_dictionary=True, update_weights=True,
                   update_scale_factors=True, data=None, **kwargs):
        kernel = jnp.asarray(kernel)
        n_samples = kernel.shape[0]
        if kernel.ndim != 2 or kernel.shape[1] != n_samples:
            raise ValueError(
                'Expected square kernel matrix in %s. Got shape %s'
                % ('kernel_aa', tuple(kernel.shape)))

        if self.n_components is None:
            self.n_components = n_samples
        self._validate_params()

        dictionary, weights, alpha = self._prepare_state(
            kernel, dictionary, weights, alpha,
            update_dictionary, update_weights, '_kernel_aa', **kwargs)

        # Full alternating fits route to the SPMD program when a mesh
        # is given; partial-update sub-fits (e.g. transform's
        # weights-only solve) are small and stay single-device.
        if (self.mesh is not None and update_dictionary and update_weights
                and (float(self.delta) == 0.0 or update_scale_factors)
                and data is None):
            return self._kernel_aa_sharded(kernel, dictionary, weights,
                                           alpha)

        (self.weights, self.dictionary, self.alpha, cost, n_iter,
         avg_time, cost_deltas) = iterate_kernel_aa(
            kernel, weights, dictionary, alpha, delta=self.delta,
            update_weights=update_weights,
            update_dictionary=update_dictionary,
            update_scale_factors=update_scale_factors,
            data=data,
            tolerance=self.tolerance,
            max_iterations=self.max_iterations,
            verbose=self.verbose,
            require_monotonic_cost_decrease=(
                self.require_monotonic_cost_decrease),
            stopping_criterion=self.stopping_criterion,
            weights_solver_kwargs=self.weights_solver_kwargs,
            dictionary_solver_kwargs=self.dictionary_solver_kwargs,
            scale_factors_solver_kwargs=self.scale_factors_solver_kwargs)

        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)

        return cost, n_iter, avg_time, cost_deltas

    def _kernel_aa_sharded(self, kernel, dictionary, weights, alpha):
        """SPMD fit over the estimator's mesh (single restart, every
        device on the sample axis)."""
        # Deferred import: parallel imports this module's cost helpers.
        from ..parallel.sharded_aa import sharded_kernel_aa_fit

        mesh = prepare_estimator_mesh(self.mesh, kernel.shape[0],
                                      'KernelAA(mesh=...)')
        start = time.perf_counter()
        res = sharded_kernel_aa_fit(
            mesh, kernel, weights[None], dictionary[None], alpha[None],
            delta=self.delta, tolerance=self.tolerance,
            max_iterations=int(self.max_iterations),
            stopping_criterion=self.stopping_criterion,
            dictionary_solver_kwargs=self.dictionary_solver_kwargs,
            weights_solver_kwargs=self.weights_solver_kwargs,
            scale_factors_solver_kwargs=self.scale_factors_solver_kwargs)
        cost = jax.block_until_ready(res['cost'])
        elapsed = time.perf_counter() - start

        self.weights = res['weights']
        # The sharded fit returns the alpha-scaled dictionary
        # (data-space convention); KernelAA stores the raw
        # right-stochastic C like the reference (:857-868).
        self.alpha = res['alpha']
        if float(self.delta) != 0.0:
            self.dictionary = res['dictionary'] / self.alpha[:, None]
        else:
            self.dictionary = res['dictionary']

        n_iter = int(res['n_iter'])
        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)
        cost_deltas = np.asarray(res['cost_deltas'])[:n_iter]
        return cost, n_iter, elapsed / max(n_iter, 1), cost_deltas

    def fit_transform(self, data, dictionary=None, weights=None, alpha=None,
                      _data_matrix=None, **kwargs):
        """Fit kernel AA to ``data`` (a kernel matrix) and return weights."""
        cost, n_iter, avg_time, cost_deltas = self._kernel_aa(
            data, dictionary=dictionary, weights=weights, alpha=alpha,
            data=_data_matrix, **kwargs)
        self.cost = float(cost)
        self.n_iter = n_iter
        self.avg_time_per_iter = avg_time
        self.cost_deltas = cost_deltas
        return self.weights

    def fit(self, kernel, **kwargs):
        self.fit_transform(kernel, **kwargs)
        return self


class ArchetypalAnalysis:
    """Standard archetypal analysis: ``min ||X - a Z C X||^2_F``.

    API parity with the reference ``ArchetypalAnalysis``
    (archetypal_analysis.py:913-1215); internally forms the Gram matrix
    once and runs the kernel-space iteration (identical mathematics; see
    module docstring).

    Extension: ``mesh=`` runs the fit as an explicit SPMD program
    over the mesh's ``samples`` axis
    (``parallel.sharded_aa.sharded_aa_fit``): data rows, their kernel
    block, and the per-row weight QPs stay device-local; the cost is
    the same explicit-residual form as the single-device path.
    """

    def __init__(self, n_components, delta=0, init=None,
                 tolerance=1e-6, max_iterations=1000, verbose=0,
                 random_state=None, mesh=None, **kwargs):
        self._kernel_model = KernelAA(
            n_components, delta=delta, init=init, tolerance=tolerance,
            max_iterations=max_iterations, verbose=verbose,
            random_state=random_state, **kwargs)
        self.n_components = n_components
        self.delta = delta
        self.init = init
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        self.verbose = verbose
        self.mesh = mesh

        self.weights = None
        self.dictionary = None
        self.alpha = None
        self.archetypes = None
        self.cost = 0
        self.n_iter = 0
        self.avg_time_per_iter = 0
        self.cost_deltas = None

    @property
    def weights_solver_kwargs(self):
        return self._kernel_model.weights_solver_kwargs

    def fit_transform(self, data, dictionary=None, weights=None, alpha=None,
                      **kwargs):
        """Fit AA to ``data`` with shape (n_samples, n_features)."""
        data = jnp.asarray(data)
        if self.n_components is None:
            # Reference quirk kept for parity: data-space AA defaults to
            # n_features components (archetypal_analysis.py:1034-1035).
            self.n_components = data.shape[1]
            self._kernel_model.n_components = data.shape[1]

        if self.mesh is not None \
                and kwargs.get('update_dictionary', True) \
                and kwargs.get('update_weights', True) \
                and (float(self.delta) == 0.0
                     or kwargs.get('update_scale_factors', True)):
            # Route BEFORE forming the n x n Gram: the SPMD fit builds
            # its local kernel blocks internally, so materializing the
            # full Gram here would defeat the memory scaling mesh=
            # provides (_fit_sharded forms it only for furthest_sum
            # init, which inherently needs the full dissimilarities).
            return self._fit_sharded(data, dictionary, weights,
                                     alpha, **kwargs)

        with matmul_precision_scope():
            kernel = data @ data.T

        self._kernel_model.fit_transform(
            kernel, dictionary=dictionary, weights=weights, alpha=alpha,
            _data_matrix=data, **kwargs)

        km = self._kernel_model
        self.weights = km.weights
        self.alpha = km.alpha
        self.cost = km.cost
        self.n_iter = km.n_iter
        self.avg_time_per_iter = km.avg_time_per_iter
        self.cost_deltas = km.cost_deltas

        dictionary = km.dictionary
        if self.delta != 0:
            dictionary = self.alpha[:, None] * dictionary
        self.dictionary = dictionary
        self.archetypes = dictionary @ data

        return self.weights

    def _fit_sharded(self, data, dictionary, weights, alpha, **kwargs):
        """SPMD fit over the estimator's mesh (single restart, every
        device on the sample axis); explicit-residual cost like the
        single-device data path."""
        # Deferred import: parallel imports this module's cost helpers.
        from ..parallel.sharded_aa import sharded_aa_fit

        km = self._kernel_model
        mesh = prepare_estimator_mesh(self.mesh, data.shape[0],
                                      'ArchetypalAnalysis(mesh=...)')
        km._validate_params()
        if km.init in (None, 'furthest_sum'):
            # FurthestSum init needs the full dissimilarity structure.
            with matmul_precision_scope():
                kernel = data @ data.T
        else:
            # random/custom init only read the kernel's row count and
            # dtype — a (n, 0) stand-in avoids the n^2 materialization.
            kernel = data[:, :0]
        init_kwargs = {k: v for k, v in kwargs.items()
                       if k not in ('update_dictionary', 'update_weights',
                                    'update_scale_factors')}
        dictionary, weights, alpha = km._prepare_state(
            kernel, dictionary, weights, alpha, True, True,
            'fit_transform', **init_kwargs)

        start = time.perf_counter()
        res = sharded_aa_fit(
            mesh, data, weights[None], dictionary[None], alpha[None],
            delta=self.delta, tolerance=self.tolerance,
            max_iterations=int(self.max_iterations),
            stopping_criterion=km.stopping_criterion,
            dictionary_solver_kwargs=km.dictionary_solver_kwargs,
            weights_solver_kwargs=km.weights_solver_kwargs,
            scale_factors_solver_kwargs=km.scale_factors_solver_kwargs)
        cost = jax.block_until_ready(res['cost'])
        elapsed = time.perf_counter() - start

        self.weights = res['weights']
        self.alpha = res['alpha']
        # sharded_aa_fit already applies the alpha scaling for
        # delta != 0 — the data-space convention this class uses.
        self.dictionary = res['dictionary']
        self.archetypes = self.dictionary @ data
        self.cost = float(cost)
        n_iter = int(res['n_iter'])
        self.n_iter = n_iter
        self.avg_time_per_iter = elapsed / max(n_iter, 1)
        self.cost_deltas = np.asarray(res['cost_deltas'])[:n_iter]
        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)
        return self.weights

    def fit(self, data, **kwargs):
        self.fit_transform(data, **kwargs)
        return self

    def transform(self, data):
        """Solve weights for new data against the fitted archetypes.

        Parity with reference ``ArchetypalAnalysis.transform``
        (archetypal_analysis.py:1151-1199).  Returns ``(weights, cost)``.
        """
        data = jnp.asarray(data)
        n_samples = data.shape[0]

        cfg = make_config(QPSolverConfig, dict(
            self._kernel_model.weights_solver_kwargs) or None)
        # Reference uses the estimator-level max_iterations for transform.
        cfg_kwargs = cfg.kwargs()
        cfg_kwargs['backend'] = cfg.backend
        cfg_kwargs['max_iterations'] = int(self.max_iterations)

        archetypes = jnp.asarray(self.archetypes)
        Z0 = right_stochastic_matrix(
            self._kernel_model._next_key(),
            (n_samples, self.n_components), dtype=data.dtype)

        if self.mesh is not None:
            # The per-row QPs are size-agnostic: shard when the rows
            # divide the sample axis, otherwise fall back to the
            # single-device solve (fit-on-big / transform-on-arbitrary
            # row counts must keep working).
            from ..parallel.mesh import ensure_mesh_axes
            m = ensure_mesh_axes(self.mesh)
            if (m.shape['restarts'] == 1
                    and n_samples % m.shape['samples'] == 0):
                return self._transform_sharded(data, archetypes, Z0,
                                               cfg_kwargs)

        with matmul_precision_scope():
            A = archetypes @ archetypes.T
            B = -(data @ archetypes.T)
            weights = quad_simplex_spg_batch(A, B, Z0, **cfg_kwargs)
            self.weights = weights
            resid = data - weights @ archetypes
        cost = 0.5 * float(jnp.sum(resid * resid)) / n_samples
        return weights, cost

    def _transform_sharded(self, data, archetypes, Z0, cfg_kwargs):
        """Mesh-sharded transform: the per-row weight QPs are
        embarrassingly data-parallel over the sample axis (shared
        k x k Hessian, no collectives until the final cost psum)."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        # Deferred import (parallel imports this module's helpers):
        # static vma checking, same policy switch as the SPMD layer.
        from ..parallel.sharded_aa import CHECK_VMA

        n_samples = data.shape[0]
        mesh = prepare_estimator_mesh(
            self.mesh, n_samples, 'ArchetypalAnalysis.transform(mesh=...)')

        with matmul_precision_scope():
            A = archetypes @ archetypes.T
            B = -(data @ archetypes.T)

            @functools.partial(
                shard_map, mesh=mesh,
                in_specs=(P('samples', None), P('samples', None),
                          P('samples', None)),
                out_specs=(P('samples', None), P()),
                check_vma=CHECK_VMA)
            def solve(data_loc, B_loc, Z0_loc):
                W_loc = quad_simplex_spg_batch(A, B_loc, Z0_loc,
                                               **cfg_kwargs)
                resid = data_loc - W_loc @ archetypes
                ss = jax.lax.psum(jnp.sum(resid * resid), 'samples')
                return W_loc, ss

            weights, ss = solve(data, B, Z0)
        self.weights = weights
        return weights, 0.5 * float(ss) / n_samples

    def inverse_transform(self, weights):
        """Map weights back to data space: ``Z @ archetypes``."""
        return jnp.asarray(weights) @ jnp.asarray(self.archetypes)
