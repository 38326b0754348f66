"""Library-wide matmul precision policy.

JAX's DEFAULT matmul precision lets XLA run float32 matmuls at reduced
precision: on the NVIDIA H100 it may use the TF32 tensor cores, which
keep a 10-bit mantissa (about three decimal digits).  For this library
that is not a harmless speed default: the alternating solvers drive
sub-problems to tolerances of 1e-4..1e-12 (reference wrappers:
run_hadisst_aa_wrapper.sh:40-44), and every Hessian, gradient
contraction, and cost evaluation flows through a matmul.  Truncated
matmul inputs floor the reachable cost decades early and make the
alternating steps oscillate, burning the iteration budget.

Accuracy is therefore the library default: every public entry point
traces its matmuls under ``jax.default_matmul_precision('float32')``,
which on the GPU keeps float32 matmuls off TF32 (chip_smoke.py checks
the flagship's Gram against float64 to 1e-5).  What the cheaper policies
('tensorfloat32': TF32 tensor cores; 'bfloat16') cost in fit quality
and gain in time on the H100 is not yet measured.  Speed-hungry users
can opt down globally::

    import convex_dim_red_tpu as cdr
    cdr.set_matmul_precision('tensorfloat32')   # or 'bfloat16'

(Changing the policy clears JAX's compilation caches: the policy is
captured at trace time and is deliberately not part of the jit cache
key.)
"""

import functools

import jax

__all__ = [
    "get_matmul_precision",
    "set_matmul_precision",
    "matmul_precision_scope",
    "apply_matmul_precision",
]

_ALLOWED = ("bfloat16", "tensorfloat32", "float32", "fastest", "highest")

_matmul_precision = "float32"


def get_matmul_precision():
    """The library's current matmul precision policy string."""
    return _matmul_precision


def set_matmul_precision(precision):
    """Set the matmul precision used by all library entry points.

    One of ``'bfloat16'``, ``'tensorfloat32'``, ``'float32'``
    (aliases ``'fastest'``/``'highest'``).  Clears JAX's compilation
    caches so already-compiled library functions re-trace under the
    new policy.
    """
    global _matmul_precision
    if precision not in _ALLOWED:
        raise ValueError(
            "matmul precision must be one of %s, got %r"
            % (", ".join(_ALLOWED), precision))
    if precision != _matmul_precision:
        _matmul_precision = precision
        jax.clear_caches()


def matmul_precision_scope():
    """Context manager applying the library policy at trace time."""
    return jax.default_matmul_precision(_matmul_precision)


def apply_matmul_precision(fn):
    """Decorator: run ``fn`` (typically a jitted entry point) under the
    library matmul precision policy.  The scope is active during
    tracing, so every matmul the function (and its callees) stages is
    emitted at the policy precision."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with matmul_precision_scope():
            return fn(*args, **kwargs)

    if hasattr(fn, "lower"):
        # Preserve the jit inspection surface (AOT lowering happens at
        # trace time, so it must run under the scope too).
        def lower(*args, **kwargs):
            with matmul_precision_scope():
                return fn.lower(*args, **kwargs)

        wrapper.lower = lower

    return wrapper
