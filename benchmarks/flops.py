"""Structural FLOP accounting for the AA alternating update.

BASELINE.md asks for "alternating-update GFLOP/s"; this module counts
the floating-point work of the matmuls that *structurally must* happen
per outer iteration of the kernel-AA fit (models/archetypal_analysis.py
``_kernel_aa_core``, has_data path), so measured wall-clock converts to
a defensible GFLOP/s figure.

Counted per outer iteration (n samples, d features, k components,
one restart), 2 flops per multiply-add:

- dictionary SPG, ``dict_iters`` + 1 Hessian applications
  ``DZ'ZD @ (C @ K) / n``: each ``2kn^2 + 2k^2 n``
- post-update recontractions ``CK`` (2kn^2), ``CKC'`` (2k^2 n),
  ``CKZ`` (2k^2 n), ``CX`` (2knd)
- weights-stage recontractions ``Z'Z`` (2nk^2), ``KZ`` (2kn^2),
  ``CKZ`` (2k^2 n)
- two residual cost evaluations ``Z (aCX) - X`` + sum of squares:
  each ``2nkd + 3nd``

NOT counted (documented exclusions, all asymptotically subdominant for
the case-study shapes where d >> k and n >> k): the per-row weights-QP
inner iterations (``2nk^2`` per inner iteration — a data-dependent
trip count; at k=6, n=1788 one inner iteration is ~0.013% of an outer
iteration), simplex projections/sorts, and vector bookkeeping.  The
reported GFLOP/s is therefore a *lower bound* on achieved throughput.
"""

__all__ = ["aa_outer_iteration_flops", "gram_flops", "peak_flops",
           "PEAKS"]


def aa_outer_iteration_flops(n, d, k, dict_iters=1):
    """FLOPs of one outer alternating iteration for one restart."""
    hessian_apps = dict_iters + 1
    dict_spg = hessian_apps * (2 * k * n * n + 2 * k * k * n)
    post_dict = (2 * k * n * n + 2 * k * k * n + 2 * k * k * n
                 + 2 * k * n * d)
    weights_stage = 2 * n * k * k + 2 * k * n * n + 2 * k * k * n
    cost_evals = 2 * (2 * n * k * d + 3 * n * d)
    return dict_spg + post_dict + weights_stage + cost_evals


def gram_flops(n, d):
    """FLOPs of the one-time Gram matmul ``X @ X'``."""
    return 2 * n * n * d


#: Published dense peaks (FLOP/s) per matmul precision policy
#: (utils/precision.py), keyed by ``jax.Device.device_kind``.  Source:
#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
#: 700 W power limit; 'float32' runs outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,
        "tensorfloat32": 495e12,
        "float32": 67e12,
    },
}


def peak_flops(device_kind, precision):
    """Published peak FLOP/s of ``device_kind`` at a matmul precision
    policy.  An unknown device or precision is an error, not a
    default."""
    try:
        return PEAKS[device_kind][precision]
    except KeyError:
        raise ValueError(
            "no published peak for %r at precision %r; known devices: %s"
            % (device_kind, precision, sorted(PEAKS))) from None
