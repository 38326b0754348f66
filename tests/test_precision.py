"""Matmul precision policy: library entry points must trace their
matmuls under the policy precision ('float32' by default — JAX's
DEFAULT may run f32 matmuls at reduced precision (TF32 on the GPU),
which floors the reachable cost early; see utils/precision.py)."""

import jax
import numpy as np
import pytest

import convex_dim_red_tpu as cdr
from convex_dim_red_tpu.utils.precision import apply_matmul_precision


def test_default_policy_is_float32():
    assert cdr.get_matmul_precision() == 'float32'


def test_set_matmul_precision_validates():
    with pytest.raises(ValueError):
        cdr.set_matmul_precision('float16')
    assert cdr.get_matmul_precision() == 'float32'


def test_scope_applies_policy_at_trace_time():
    seen = {}

    @apply_matmul_precision
    def probe():
        seen['val'] = jax.config.jax_default_matmul_precision

    probe()
    assert seen['val'] == 'float32'


@pytest.mark.slow
def test_set_matmul_precision_roundtrip_retraces():
    captured = []

    @apply_matmul_precision
    def probe():
        captured.append(jax.config.jax_default_matmul_precision)

    try:
        cdr.set_matmul_precision('bfloat16')
        probe()
        assert captured[-1] == 'bfloat16'
    finally:
        cdr.set_matmul_precision('float32')
    probe()
    assert captured[-1] == 'float32'


def test_entry_points_emit_policy_precision_dots():
    """The compiled HLO of a core entry point must carry the highest
    operand precision on its dot ops (trace-time proof the policy is
    actually applied where the FLOPs happen)."""
    from convex_dim_red_tpu.solvers.spg import quad_simplex_spg_batch

    rng = np.random.RandomState(0)
    A = np.eye(3) + 0.1 * rng.standard_normal((3, 3))
    A = (A + A.T) / 2 + np.eye(3)
    B = rng.standard_normal((5, 3))
    X0 = rng.dirichlet(np.ones(3), 5)

    fn = jax.jit(lambda a, b, x: quad_simplex_spg_batch(a, b, x,
                                                        max_iterations=3))
    text = fn.lower(A, B, X0).as_text()
    assert 'dot' in text
    # Every dot in the program must be HIGHEST precision.
    for line in text.splitlines():
        if 'dot_general' in line and 'precision' in line:
            assert 'HIGHEST' in line, line
