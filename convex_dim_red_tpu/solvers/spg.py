"""Spectral projected gradient (SPG) solvers.

Implements Birgin–Martinez–Raydan SPG (Algorithm 813) with a Grippo
nonmonotone line search and Barzilai–Borwein (Cauchy) step sizes, as two
jittable solvers:

- :func:`spg` — generic projected-gradient descent over user callables
  ``f``/``df``/``project``.  Behavioral parity with the reference's
  Python implementation (src/convex_dim_red/spg.py:46-283): same
  zero-initialized nonmonotone memory, same step-length safeguards, same
  dual (2-norm / infinity-norm) convergence criteria.  The three
  data-dependent loops of the reference (descent iterations, line search,
  convergence) become ``lax.while_loop``s so the whole solve stays on
  device inside one XLA computation.

- :func:`quad_spg` — operator-form projected spectral gradient for
  exact QPs with closed-form line minimization (see its docstring); it
  powers :func:`quad_simplex_spg` (the reference's simplex QP,
  spg.py:286-398) and all AA subproblem updates.
  :func:`quad_simplex_spg_batch` vmaps the simplex QP over rows with a
  shared Hessian: under ``vmap`` the per-row ``A @ x`` matvecs fuse into
  ``X @ A`` matmuls, and per-row convergence is handled by vmap's
  lockstep masking of the while loops (the vectorization the reference
  gets from ``guvectorize(..., target='parallel')`` threads, reference
  archetypal_analysis.py:344-366); ``backend='pallas'`` instead runs the
  whole solve in one fused GPU kernel launch (ops/pallas_qp.py).

Differences from the reference (documented, not behavioral bugs):
``n_iter`` counts iterations executed (reference returns the last
zero-based loop index); the generic ``spg``'s final redundant ``f(x)``
re-evaluation is reused rather than recomputed (identical value; the
feval counter still mirrors the reference's bookkeeping so ``max_feval``
caps align); the QP solvers use the closed-form exact line minimizer in
place of Armijo backtracking (see :func:`quad_simplex_spg`).
"""

import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.vma import pvary_like
from ..ops.simplex_projection import (simplex_project_masked,
                                      simplex_project_vector)
from ..utils.precision import apply_matmul_precision

__all__ = [
    "spg",
    "quad_spg",
    "quad_simplex_spg",
    "quad_simplex_spg_batch",
    "quad_simplex_spg_batch_grouped",
    "resolve_qp_backend",
    "line_search_step_length",
    "cauchy_step_size",
]


def resolve_qp_backend(backend, k=None, regime="oneshot"):
    """Resolve a weights-QP backend choice to ``'xla'`` or ``'pallas'``.

    ``'pallas'`` is the fused GPU kernel (ops/pallas_qp.py), ``'xla'``
    the portable vmapped solver.  ``'auto'`` resolves by call regime:

    - ``regime='fit'`` (warm-started QPs inside the vmapped
      single-restart fit loops) resolves to ``'xla'``;
    - ``regime='oneshot'`` (a cold batch solved once) and
      ``regime='sharded_fit'`` (the restart-batched QPs of the grouped
      and mesh-sharded fits) resolve to ``'pallas'`` on the GPU when
      ``k`` fits the kernel, and to ``'xla'`` elsewhere.

    Measured on one NVIDIA H100 80GB HBM3 at a 400 W power limit
    (benchmarks/qp_kernel_ab.py, medians of 6 warm runs, PERF.md):

    - the isolated grouped solve at R=25, n=1788, k=6 takes 0.36 ms
      fused against 2.97 ms in XLA at an inner cap of 25, and 0.52 ms
      against 5.94 ms at the default cap of 1000;
    - the flagship best-of-100 fit (bench.py's workload) takes 3.03 s
      with the fused kernel against 3.24 s with XLA end to end.

    The ``'fit'`` regime was not measured and keeps XLA.  An explicit
    ``'pallas'`` with ``k`` above the kernel's limit raises
    ``ValueError``, as does an unknown backend.
    """
    from ..ops.pallas_qp import MAX_K
    if regime not in ("oneshot", "fit", "sharded_fit"):
        raise ValueError("unknown QP dispatch regime %r" % (regime,))
    if backend not in ("xla", "pallas", "auto"):
        raise ValueError("unknown weights-QP backend %r; use 'xla', "
                         "'pallas' or 'auto'" % (backend,))
    if backend == "pallas" and k is not None and k > MAX_K:
        raise ValueError("the pallas QP kernel supports k <= %d, got %d; "
                         "use backend='xla'" % (MAX_K, k))
    if backend != "auto":
        return backend
    if regime == "fit" or jax.default_backend() != "gpu":
        return "xla"
    if k is not None and k > MAX_K:
        return "xla"
    return "pallas"


def line_search_step_length(lam, delta, f_old, f_new,
                            sigma_one=0.1, sigma_two=0.9):
    """Safeguarded quadratic-interpolation step length.

    Parity with reference ``spg_line_search_step_length``
    (spg.py:19-33); a non-finite interpolation (zero curvature) falls
    back to bisection exactly as the reference's range check does.
    """
    denom = f_new - f_old - lam * delta
    tmp = -0.5 * lam * lam * delta / denom
    ok = (sigma_one <= tmp) & (tmp <= sigma_two * lam)
    return jnp.where(ok, tmp, 0.5 * lam)


def cauchy_step_size(beta, sksk, alpha_min=1e-3, alpha_max=1e3):
    """Barzilai–Borwein (Cauchy) step size with safeguards.

    Parity with reference ``spg_line_search_cauchy_step_size``
    (spg.py:36-43).
    """
    safe_beta = jnp.where(beta <= 0, 1.0, beta)
    return jnp.where(beta <= 0, alpha_max,
                     jnp.clip(sksk / safe_beta, alpha_min, alpha_max))


def _norms(res):
    res2 = jnp.sqrt(jnp.sum(res * res))
    resinf = jnp.max(jnp.abs(res))
    return res2, resinf


def _emit_spg_warnings(underflow, feval_exceeded, iter_exceeded):
    """Reference's soft-failure UserWarnings (spg.py:225-229, :271-276,
    :278-281), emitted host-side from the flags carried out of the
    jitted solve."""
    if np.any(underflow):
        warnings.warn('step size below tolerance in SPG line search',
                      UserWarning)
    if np.any(feval_exceeded):
        warnings.warn('maximum number of function evaluations exceeded '
                      'in SPG', UserWarning)
    if np.any(iter_exceeded):
        warnings.warn('maximum number of iterations exceeded in SPG',
                      UserWarning)


class _VerboseTable:
    """Host-side printer reproducing the reference's fixed-width SPG
    iteration table (spg.py:159-164, :256-259), fed per-iteration
    through ``jax.debug.callback``.  Wall time per row is measured on
    the host between callback deliveries (the compiled loop itself has
    no clock)."""

    _HEADER = '{:<12s} | {:<12s} | {:<13s} | {:<13s} | {:<12s}'.format(
        'n_iter', 'n_feval', 'f', 'conv_crit', 'time')
    _ROW = '{:12d} | {:12d} | {: 12.6e} | {: 12.6e} | {: 12.6e}'

    def __init__(self):
        self._last = None

    def header(self, n_feval, f0):
        print(self._HEADER)
        print('-' * 79)
        print(self._ROW.format(0, int(n_feval), float(f0), -1.0, 0.0))
        self._last = time.perf_counter()

    def row(self, n_iter, n_feval, f, conv_crit):
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        print(self._ROW.format(int(n_iter), int(n_feval), float(f),
                               float(conv_crit), dt))

    def footer(self, converged, n_iter):
        if bool(converged):
            print('-' * 79)
            print('*** Converged at iteration {:d} ***'.format(int(n_iter)))


@apply_matmul_precision
def spg(f, df, x0, project=None, gamma=1e-4, memory=1,
        sigma_one=0.1, sigma_two=0.9, lambda_min=1e-10,
        alpha0=None, alpha_min=1e-5, alpha_max=1e3,
        epsilon_one=1e-10, epsilon_two=1e-6,
        use_infinity_norm=True, verbose=0,
        max_iterations=10000, max_feval=1000000):
    """Minimize ``f`` by projected gradient descent with nonmonotone
    line search.

    Parameters mirror the reference ``spg`` (spg.py:46-134).  ``f``,
    ``df`` and ``project`` must be JAX-traceable; ``x0`` may be a scalar
    or an array of any shape.  Fully jittable.

    Returns ``(x, f_min, n_iter, n_feval)`` where ``n_iter`` is the
    number of descent iterations executed.
    """
    x = jnp.asarray(x0)
    dtype = (x.dtype if jnp.issubdtype(x.dtype, jnp.floating)
             else jnp.result_type(float))
    x = x.astype(dtype)

    if project is not None:
        x = project(x)

    f_old = f(x)
    n_feval = jnp.asarray(1, dtype=jnp.int32)
    gk = df(x)

    if alpha0 is not None:
        alpha = jnp.asarray(alpha0, dtype=dtype)
    elif project is None:
        alpha = 1.0 / jnp.max(jnp.abs(gk))
    else:
        alpha_inv = jnp.max(jnp.abs(project(x - gk) - x))
        alpha = jnp.where(jnp.abs(alpha_inv) > 1e-12, 1.0 / alpha_inv, 1.0)

    # Reference initializes the nonmonotone memory with zeros (spg.py:153).
    f_mem = jnp.zeros((memory,), dtype=dtype)

    verbose = bool(verbose)
    table = _VerboseTable() if verbose else None
    if verbose:
        jax.debug.callback(table.header, n_feval, f_old, ordered=True)

    def _dir(x, g, a):
        if project is None:
            return -a * g
        return project(x - a * g) - x

    def _residual(x, g):
        if project is None:
            return -g
        return project(x - g) - x

    def cond(carry):
        (x, gk, alpha, f_old, f_mem, n_iter, n_feval, done,
         converged, underflow) = carry
        return (~done) & (n_iter < max_iterations)

    def body(carry):
        (x, gk, alpha, f_old, f_mem, n_iter, n_feval, done,
         converged, underflow) = carry

        dk = _dir(x, gk, alpha)

        f_mem_new = jnp.roll(f_mem, 1).at[0].set(f_old)
        f_max = jnp.max(f_mem_new)

        delta = jnp.sum(dk * gk)

        lam = jnp.asarray(1.0, dtype=dtype)
        x_new = x + dk
        f_new = f(x_new)
        n_feval = n_feval + 1

        def ls_cond(ls):
            lam, x_new, f_new, n_feval, uf = ls
            return (f_new > f_max + gamma * lam * delta) & (~uf)

        def ls_body(ls):
            lam, x_new, f_new, n_feval, uf = ls
            lam = line_search_step_length(
                lam, delta, f_old, f_new, sigma_one, sigma_two)
            x_new = x + lam * dk
            f_new = f(x_new)
            uf = jnp.abs(lam) < lambda_min
            return lam, x_new, f_new, n_feval + 1, uf

        lam, x_new, f_new, n_feval, uf = jax.lax.while_loop(
            ls_cond, ls_body,
            (lam, x_new, f_new, n_feval, jnp.asarray(False)))
        underflow = underflow | uf

        gk_new = df(x_new)
        yk = gk_new - gk

        sksk = lam * lam * jnp.sum(dk * dk)
        betak = lam * jnp.sum(dk * yk)
        alpha = cauchy_step_size(betak, sksk, alpha_min, alpha_max)

        # Reference recomputes f(x) here (spg.py:243) — identical value;
        # reuse it but keep the counter in lockstep.
        f_old_new = f_new
        n_feval = n_feval + 1

        res = _residual(x_new, gk_new)
        res2, resinf = _norms(res)

        if verbose:
            # Reference per-iteration table row (spg.py:256-259).
            jax.debug.callback(table.row, n_iter + 1, n_feval,
                               f_old_new, res2, ordered=True)

        converged = res2 < epsilon_two
        if use_infinity_norm:
            converged = converged | (resinf < epsilon_one)

        done = converged | (n_feval > max_feval)

        return (x_new, gk_new, alpha, f_old_new, f_mem_new,
                n_iter + 1, n_feval, done, converged, underflow)

    init = (x, gk, alpha, f_old, f_mem,
            jnp.asarray(0, dtype=jnp.int32), n_feval, jnp.asarray(False),
            jnp.asarray(False), jnp.asarray(False))
    (x, gk, alpha, f_old, f_mem, n_iter, n_feval, done,
     converged, underflow) = jax.lax.while_loop(cond, body, init)

    if verbose:
        jax.debug.callback(table.footer, converged, n_iter, ordered=True)

    # Soft failures surface as the reference's UserWarnings
    # (spg.py:225-229, :271-281): immediately on eager calls, via a host
    # callback when the solve is traced under jit/vmap.
    feval_exceeded = (n_feval > max_feval) & ~converged
    iter_exceeded = (n_iter >= max_iterations) & ~converged
    if isinstance(jnp.asarray(underflow), jax.core.Tracer):
        jax.debug.callback(_emit_spg_warnings, underflow,
                           feval_exceeded, iter_exceeded)
    else:
        _emit_spg_warnings(np.asarray(underflow),
                           np.asarray(feval_exceeded),
                           np.asarray(iter_exceeded))

    return x, f_old, n_iter, n_feval


@apply_matmul_precision
def quad_spg(matvec, B, x0, project, alpha0=-1.0,
             alpha_min=1e-5, alpha_max=1e3,
             epsilon_one=1e-10, epsilon_two=1e-6,
             max_iterations=1000):
    """Projected spectral gradient for ``min 0.5<x,Hx> - <B,x>`` over a
    convex set, with H given as a PSD linear operator ``matvec``.

    ``x0``/``B`` may be arrays of any shape (vector or matrix variables);
    ``project`` maps onto the feasible set.  Uses Barzilai–Borwein step
    sizes with the closed-form exact line minimizer along the projected
    direction (the objective restricted to the segment is an exact 1-D
    quadratic), so no objective values are ever compared — in float32
    this is what keeps the solver from stalling on cancellation (see
    :func:`quad_simplex_spg`).  One ``matvec`` per iteration; ``H x`` is
    carried incrementally.

    This one solver powers all three AA subproblems (weights rows,
    dictionary, scale factors) and the GPNH weights update; the reference
    solves each with the Armijo-backtracking machinery of spg.py:46-398.
    """
    x = project(jnp.asarray(x0))
    dtype = x.dtype
    B = jnp.asarray(B)

    Hx = matvec(x)
    g0 = Hx - B
    if alpha_min <= alpha0 <= alpha_max:
        alpha = jnp.asarray(alpha0, dtype=dtype)
    else:
        alpha_inv = jnp.max(jnp.abs(project(x - g0) - x))
        alpha_inv = jnp.where(jnp.abs(alpha_inv) < 1e-12, 1.0, alpha_inv)
        alpha = jnp.clip(1.0 / alpha_inv, alpha_min, alpha_max)

    # Progress-based exit: the exact per-iteration decrease
    # -(lam*delta + lam^2/2 q) is formed from line-search scalars with no
    # cancellation.  Once it falls below the dtype's resolution of the
    # objective for a few consecutive iterations, further iterations
    # cannot make representable progress (this matters when alpha_min
    # clips the BB step far above 1/lambda_max on badly scaled problems:
    # the residual criteria never fire but every step is microscopic).
    progress_eps = 32.0 * float(jnp.finfo(dtype).eps)
    stall_limit = 3

    def cond(carry):
        x, Hx, alpha, n_iter, stall_count, done = carry
        return (~done) & (n_iter < max_iterations)

    def body(carry):
        x, Hx, alpha, n_iter, stall_count, done = carry

        g = Hx - B
        d = project(x - alpha * g) - x
        Hd = matvec(d)

        delta = jnp.sum(d * g)
        q = jnp.sum(d * Hd)

        safe_q = jnp.where(q > 0, q, 1.0)
        lam = jnp.where(q > 0, jnp.clip(-delta / safe_q, 0.0, 1.0),
                        jnp.asarray(1.0, dtype=dtype))

        x_new = x + lam * d
        Hx_new = Hx + lam * Hd

        sksk = jnp.sum(d * d)
        alpha = cauchy_step_size(q, sksk, alpha_min, alpha_max)

        g_new = Hx_new - B
        res = project(x_new - g_new) - x_new
        res2, resinf = _norms(res)

        decrease = -(lam * delta + 0.5 * lam * lam * q)
        f_scale = jnp.abs(0.5 * jnp.sum(x_new * Hx_new)
                          - jnp.sum(B * x_new)) + jnp.finfo(dtype).tiny
        no_progress = decrease <= progress_eps * f_scale
        stall_count = jnp.where(no_progress, stall_count + 1, 0)

        done = ((res2 < epsilon_two) | (resinf < epsilon_one)
                | (stall_count >= stall_limit))
        return x_new, Hx_new, alpha, n_iter + 1, stall_count, done

    init = (x, Hx, alpha, jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32), jnp.asarray(False))
    # Under shard_map(check_vma=True) the fresh-constant carry entries
    # must be promoted to the operands' varying axes — the loop body's
    # outputs inherit them, and while_loop requires carry types (vma
    # included) to match.  No-op outside shard_map.
    init = pvary_like(init, x, Hx, B)
    x, Hx, alpha, n_iter, stall_count, done = jax.lax.while_loop(
        cond, body, init)
    # The incremental updates x += lam*d preserve feasibility only up to
    # accumulated rounding (~iters * eps); one final projection restores
    # it to a single ulp.
    return project(x)


@apply_matmul_precision
def quad_simplex_spg(A, b, x0, gamma=1e-4, memory=1,
                     sigma_one=0.1, sigma_two=0.9, lambda_min=1e-10,
                     alpha0=-1.0, alpha_min=1e-5, alpha_max=1e3,
                     epsilon_one=1e-10, epsilon_two=1e-6,
                     max_iterations=1000, max_feval=2000, mask=None):
    """Solve ``min 1/2 x'Ax + b'x`` over the standard simplex.

    Same problem, stopping criteria, and BB-step safeguards as the
    reference ``quad_simplex_spg`` (spg.py:286-398), with one deliberate
    redesign: because the objective is an exact quadratic, the
    backtracking Armijo line search is replaced by the closed-form exact
    line minimizer along the projected-gradient direction,

        lam* = clip(-(d'g) / (d'Ad), 0, 1).

    This (a) removes the nested data-dependent line-search loop (one
    matvec per iteration instead of 2+; ``A @ x`` is carried incrementally
    as ``Ax + lam * Ad``), and (b) eliminates the catastrophic
    cancellation of comparing nearly-equal objective values in float32 —
    the decrease ``lam*d'g + lam^2/2 d'Ad`` is formed from increments, so
    the solver converges instead of stalling at the iteration cap in
    float32 (measured: the Armijo variant left 53% of rows >1e-4 above
    the f64 optimum on a 1788x8 batch).  Exact line
    search makes every step monotone, so the nonmonotone memory
    parameters (``gamma``, ``memory``, ``sigma_*``, ``lambda_min``) are
    accepted for API parity but unused.

    The first-iteration step size and the dual-norm convergence test
    mirror the reference.  Jittable; designed to be ``vmap``ed over rows
    (see :func:`quad_simplex_spg_batch`).

    ``mask`` (optional boolean (k,) array, a *runtime* value) restricts
    the feasible set to the sub-simplex with masked-out coordinates
    pinned at zero (:func:`ops.simplex_projection.simplex_project_masked`)
    — the primitive behind padded-``k`` program bucketing.
    """
    del gamma, memory, sigma_one, sigma_two, lambda_min  # parity only

    A = jnp.asarray(A)
    b = jnp.asarray(b)
    if mask is None:
        project = simplex_project_vector
    else:
        mask = jnp.asarray(mask, bool)
        project = lambda x: simplex_project_masked(x, mask)
    return quad_spg(
        lambda x: A @ x, -b, x0, project,
        alpha0=alpha0, alpha_min=alpha_min, alpha_max=alpha_max,
        epsilon_one=epsilon_one, epsilon_two=epsilon_two,
        max_iterations=min(max_iterations, max_feval))


@apply_matmul_precision
def quad_simplex_spg_batch(A, B, X0, backend="xla", mask=None,
                           **solver_kwargs):
    """Solve ``n`` simplex QPs sharing the Hessian ``A`` in lockstep.

    ``A``: (k, k) shared Hessian; ``B``: (n, k) per-row linear terms;
    ``X0``: (n, k) per-row feasible initial guesses.  Returns (n, k).

    This replaces the reference's ``guvectorize(...,
    target='parallel')`` per-sample solves (archetypal_analysis.py:
    344-366, gpnh_convex_coding.py:229-251): under ``vmap`` every
    per-row matvec becomes one ``(n, k) @ (k, k)`` matmul and per-row
    convergence is masked automatically.

    ``backend='pallas'`` runs the whole solve in the fused GPU kernel
    (ops/pallas_qp.py) as a single group; see
    :func:`quad_simplex_spg_batch_grouped`.

    ``mask`` (shared across rows) restricts every row's QP to the
    masked sub-simplex.  Both backends support it; on the Pallas path
    the mask is a runtime kernel input, so masked (bucketed) and plain
    solves of one shape share a single compiled program.

    ``backend='auto'`` treats a direct call as a cold one-shot solve
    (:func:`resolve_qp_backend`).  Fit loops resolve their own backend
    before dispatching here.
    """
    backend = resolve_qp_backend(backend, k=jnp.shape(B)[1])
    if backend == "pallas":
        return quad_simplex_spg_batch_grouped(
            jnp.asarray(A)[None], jnp.asarray(B)[None],
            jnp.asarray(X0)[None], backend="pallas", mask=mask,
            **solver_kwargs)[0]
    solve = lambda b, x0: quad_simplex_spg(A, b, x0, mask=mask,
                                           **solver_kwargs)
    return jax.vmap(solve)(B, X0)


#: Solver keywords the fused kernel takes; the rest (the Armijo
#: parameters kept for API parity) do not apply to it, and
#: ``max_feval`` caps the iterations as in :func:`quad_simplex_spg`.
_PALLAS_KWARGS = ("alpha0", "alpha_min", "alpha_max", "epsilon_one",
                  "epsilon_two", "interpret")


@apply_matmul_precision
def quad_simplex_spg_batch_grouped(As, Bs, X0s, backend="xla", mask=None,
                                   **solver_kwargs):
    """Solve ``R`` groups of simplex QPs, one shared Hessian per group.

    ``As``: (R, k, k); ``Bs``/``X0s``: (R, n, k).  Returns (R, n, k).
    This is the restart-batched form of :func:`quad_simplex_spg_batch`
    used inside multi-restart fits, where every restart carries its own
    Hessian.  ``backend='pallas'`` runs all groups in ONE fused GPU
    kernel launch (the group axis is a grid dimension,
    ops/pallas_qp.py:quad_simplex_qp_pallas), each row block to its own
    convergence; ``interpret=True`` runs that kernel on any backend.
    ``mask`` is shared across groups.  ``backend='auto'`` resolves as a
    cold one-shot solve (:func:`resolve_qp_backend`).
    """
    backend = resolve_qp_backend(backend, k=jnp.shape(X0s)[2])
    if backend == "pallas":
        from ..ops.pallas_qp import quad_simplex_qp_pallas
        return quad_simplex_qp_pallas(
            As, Bs, X0s, mask=mask,
            max_iterations=min(solver_kwargs.get("max_iterations", 1000),
                               solver_kwargs.get("max_feval", 2000)),
            **{k: v for k, v in solver_kwargs.items()
               if k in _PALLAS_KWARGS})
    solve = lambda A, B, X0: quad_simplex_spg_batch(
        A, B, X0, backend="xla", mask=mask, **solver_kwargs)
    return jax.vmap(solve)(As, Bs, X0s)
