"""Pallas GPU kernel (Triton route): fused grouped simplex-QP solver.

The weights update solves, for every restart ``r``, ``n`` independent
simplex QPs ``min 1/2 x'A_r x + b'x`` sharing a tiny ``k x k`` Hessian.
The XLA implementation (solvers/spg.py:quad_simplex_spg_batch_grouped)
runs the SPG loop as a data-dependent ``lax.while_loop`` whose every
trip launches several small kernels over the whole ``(R, n, k)`` state
and reads the loop predicate back before the next trip.  This kernel
runs the whole solve in one launch: each program owns one block of
``BLOCK_ROWS`` rows of one restart, keeps ``X``, ``A X``, the BB step,
the active flags and the stall counters in registers as loop carries,
and stops as soon as *its* rows have converged.

Per program: ``A_r`` is loaded once; the ``k x k`` matvec is a
broadcast-multiply-reduce over a ``(BLOCK_ROWS, k_pad, k_pad)`` product
in plain float32 FMAs (never TF32); the simplex projection is the exact
Michelot active-set threshold with row reductions along the component
axis.  ``k`` is padded to ``k_pad``, the next power of two (Triton
tensors must have power-of-two sizes); padded lanes are masked out by
the runtime component mask, so padded-``k`` buckets share one program.

Not differentiated through (the solver is used inside fixed-point
iterations).  ``interpret=True`` runs it on the CPU for tests.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils.vma import vma_of

__all__ = ["quad_simplex_qp_pallas", "MAX_K", "launch_config"]

#: Widest problem the kernel takes (after padding to a power of two).
#: The register-resident ``(BLOCK_ROWS, k_pad, k_pad)`` matvec product
#: bounds it; wider QPs use the XLA solver.
MAX_K = 64

#: ``k_pad -> (BLOCK_ROWS, num_warps)``, tuned on an H100 (PERF.md).
#: Small blocks win: more programs in flight, and a block exits as soon
#: as its own few rows have converged.
_LAUNCH = {8: (32, 1), 16: (16, 1), 32: (4, 1), 64: (2, 2)}


def _k_pad(k):
    k_pad = 8
    while k_pad < k:
        k_pad *= 2
    return k_pad


def launch_config(k):
    """``(k_pad, BLOCK_ROWS, num_warps)`` for a ``k``-component QP."""
    k_pad = _k_pad(k)
    if k_pad > MAX_K:
        raise ValueError(
            f"pallas QP kernel supports k <= {MAX_K}, got {k}; use "
            "backend='xla'")
    return (k_pad, *_LAUNCH[k_pad])


def _qp_kernel(A_ref, B_ref, X0_ref, M_ref, out_ref, *, n_proj,
               max_iterations, alpha0, alpha_min, alpha_max, epsilon_one,
               epsilon_two):
    A = A_ref[...]            # (k_pad, k_pad)
    B = B_ref[...]            # (BLOCK_ROWS, k_pad) linear term
    mask = M_ref[...] > 0.5   # (1, k_pad) runtime component mask
    dtype = B.dtype
    rows = B.shape[0]
    mask_f = jnp.where(mask, 1.0, 0.0).astype(dtype)

    def matvec(V):
        # Row-wise V @ A as a broadcast-multiply-reduce: full-precision
        # FMAs, no tensor-core (TF32) path.
        return jnp.sum(V[:, :, None] * A[None, :, :], axis=1)

    def rowsum(v):
        return jnp.sum(v, axis=1, keepdims=True)

    def project(x):
        # Michelot: tau = (sum_active x - 1) / |active|, drop x <= tau;
        # the active set only shrinks, so n_proj = k trips reach the
        # exact threshold.  The row maximum never drops out, so the
        # count guard only protects an all-masked row.
        def tau_of(act):
            return (rowsum(x * act) - 1.0) / jnp.maximum(rowsum(act), 1.0)

        def body(_, act):
            return jnp.where(x > tau_of(act), act, 0.0)

        act = jax.lax.fori_loop(0, n_proj, body,
                                jnp.broadcast_to(mask_f, x.shape))
        return jnp.where(mask, jnp.maximum(x - tau_of(act), 0.0), 0.0)

    X = project(X0_ref[...])
    AX = matvec(X)
    if alpha_min <= alpha0 <= alpha_max:
        alpha = jnp.full((rows, 1), alpha0, dtype)
    else:
        d0 = project(X - (AX + B)) - X
        ainv = jnp.max(jnp.abs(d0), axis=1, keepdims=True)
        ainv = jnp.where(jnp.abs(ainv) < 1e-12, 1.0, ainv)
        alpha = jnp.clip(1.0 / ainv, alpha_min, alpha_max)

    progress_eps = 32.0 * float(jnp.finfo(dtype).eps)
    tiny = float(jnp.finfo(dtype).tiny)

    def cond(carry):
        it, any_active = carry[0], carry[-1]
        return (it < max_iterations) & (any_active > 0)

    def body(carry):
        # One iteration of solvers/spg.py:quad_spg, row by row, with
        # its stopping rule; rows that have stopped stay frozen.
        it, X, AX, alpha, active, stall, _ = carry
        live = active > 0
        G = AX + B
        D = project(X - alpha * G) - X
        AD = matvec(D)

        delta = rowsum(D * G)
        q = rowsum(D * AD)
        safe_q = jnp.where(q > 0, q, 1.0)
        lam = jnp.where(q > 0, jnp.clip(-delta / safe_q, 0.0, 1.0), 1.0)
        lam = jnp.where(live, lam, 0.0)

        X = X + lam * D
        AX = AX + lam * AD
        alpha = jnp.where(
            live,
            jnp.where(q > 0, jnp.clip(rowsum(D * D) / safe_q, alpha_min,
                                      alpha_max), alpha_max),
            alpha)

        res = project(X - (AX + B)) - X
        decrease = -(lam * delta + 0.5 * lam * lam * q)
        fval = jnp.abs(0.5 * rowsum(X * AX) + rowsum(X * B)) + tiny
        stall = jnp.where(decrease <= progress_eps * fval, stall + 1, 0)
        converged = ((rowsum(res * res) < epsilon_two * epsilon_two)
                     | (jnp.max(jnp.abs(res), axis=1, keepdims=True)
                        < epsilon_one)
                     | (stall >= 3))
        active = jnp.where(converged, 0, active)
        return (it + 1, X, AX, alpha, active, stall, jnp.max(active))

    init = (jnp.int32(0), X, AX, alpha, jnp.ones((rows, 1), jnp.int32),
            jnp.zeros((rows, 1), jnp.int32), jnp.int32(1))
    X = jax.lax.while_loop(cond, body, init)[1]
    # Restore exact feasibility lost to incremental-update rounding.
    out_ref[...] = project(X)


def quad_simplex_qp_pallas(As, Bs, X0s, mask=None, max_iterations=1000,
                           alpha0=-1.0, alpha_min=1e-5, alpha_max=1e3,
                           epsilon_one=1e-10, epsilon_two=1e-6,
                           interpret=False):
    """Solve ``R`` groups of simplex QPs, one Hessian per group, fused.

    ``As``: (R, k, k); ``Bs``/``X0s``: (R, n, k) linear terms and
    feasible starts of ``min 1/2 x'A_r x + b'x``.  Returns (R, n, k).
    The grid is ``(R, cdiv(n, BLOCK_ROWS))``; a single-Hessian solve is
    the case ``R = 1``.  ``mask`` (optional (k,) bool, a runtime value
    shared across groups) restricts every QP to the masked sub-simplex
    with masked coordinates pinned at exactly zero.

    Compiles for the GPU only; ``interpret=True`` runs the kernel body
    on any backend (tests).  Raises ``ValueError`` for ``k > MAX_K`` and
    for a compiled call off the GPU.
    """
    As = jnp.asarray(As)
    Bs = jnp.asarray(Bs)
    X0s = jnp.asarray(X0s)
    R, n, k = Bs.shape
    k_pad, block_rows, num_warps = launch_config(k)
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the pallas QP kernel compiles only for the GPU (backend is "
            f"{jax.default_backend()!r}); use backend='xla' or "
            "interpret=True")
    dtype = X0s.dtype
    n_pad = pl.cdiv(n, block_rows) * block_rows

    A_p = jnp.zeros((R, k_pad, k_pad), dtype).at[:, :k, :k].set(As)
    B_p = jnp.zeros((R, n_pad, k_pad), dtype).at[:, :n, :k].set(Bs)
    X0_p = jnp.zeros((R, n_pad, k_pad), dtype).at[:, :n, :k].set(X0s)
    active = (jnp.ones((k,), dtype) if mask is None
              else jnp.asarray(mask).astype(dtype))
    M_p = jnp.zeros((1, k_pad), dtype).at[0, :k].set(active)

    kernel = functools.partial(
        _qp_kernel, n_proj=int(k), max_iterations=int(max_iterations),
        alpha0=float(alpha0), alpha_min=float(alpha_min),
        alpha_max=float(alpha_max), epsilon_one=float(epsilon_one),
        epsilon_two=float(epsilon_two))
    rows_spec = pl.BlockSpec((None, block_rows, k_pad),
                             lambda r, i: (r, i, 0))
    out = pl.pallas_call(
        kernel,
        grid=(R, n_pad // block_rows),
        in_specs=[
            pl.BlockSpec((None, k_pad, k_pad), lambda r, i: (r, 0, 0)),
            rows_spec,
            rows_spec,
            pl.BlockSpec((1, k_pad), lambda r, i: (0, 0)),
        ],
        out_specs=rows_spec,
        out_shape=jax.ShapeDtypeStruct(
            (R, n_pad, k_pad), dtype,
            # shard_map(check_vma=True) requires an explicit vma on
            # pallas outputs; the solution varies exactly over the
            # operands' manual axes (no collectives inside).
            vma=frozenset(vma_of(A_p, B_p, X0_p, M_p))),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="simplex_qp_spg",
    )(A_p, B_p, X0_p, M_p)
    return out[:, :n, :k]
