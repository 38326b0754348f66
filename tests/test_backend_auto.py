"""Tests for the measured 'auto' weights-QP backend dispatch.

``resolve_qp_backend`` (solvers/spg.py) picks the QP backend per call
regime: cold one-shot batches and the restart-batched (grouped and
sharded) fits take the fused Pallas kernel on the GPU, warm-started
fit-loop QPs and every other platform resolve to XLA.  The choice is
grounded in benchmarks/qp_kernel_ab.py measurements (PERF.md); the tests
pin the dispatch contract, not the timings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convex_dim_red_tpu import ArchetypalAnalysis, resolve_qp_backend
from convex_dim_red_tpu.models._common import QPSolverConfig
from convex_dim_red_tpu.ops.pallas_qp import MAX_K
from convex_dim_red_tpu.parallel.sharded_aa import _weights_backend_kwargs
from convex_dim_red_tpu.solvers.spg import quad_simplex_spg_batch


def test_explicit_backends_pass_through():
    for backend in ("xla", "pallas"):
        for regime in ("fit", "oneshot"):
            assert resolve_qp_backend(backend, regime=regime) == backend


def test_auto_fit_regime_resolves_to_xla_everywhere(monkeypatch):
    assert resolve_qp_backend("auto", regime="fit") == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_qp_backend("auto", regime="fit") == "xla"


def test_auto_oneshot_is_xla_off_gpu():
    # conftest pins the test platform to CPU.
    assert jax.default_backend() == "cpu"
    assert resolve_qp_backend("auto") == "xla"


def test_auto_oneshot_is_pallas_on_gpu_within_kernel_width(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_qp_backend("auto") == "pallas"
    assert resolve_qp_backend("auto", k=MAX_K) == "pallas"
    # Wider than the kernel takes: fall back to XLA.
    assert resolve_qp_backend("auto", k=MAX_K + 1) == "xla"


def test_k_above_kernel_limit(monkeypatch):
    """Above the kernel's width 'auto' resolves to 'xla' and an explicit
    'pallas' raises, on every platform and in every regime."""
    for platform in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        for regime in ("oneshot", "fit", "sharded_fit"):
            assert resolve_qp_backend("auto", k=MAX_K + 1,
                                      regime=regime) == "xla"
            with pytest.raises(ValueError, match="k <= %d" % MAX_K):
                resolve_qp_backend("pallas", k=MAX_K + 1, regime=regime)
    with pytest.raises(ValueError, match="unknown weights-QP backend"):
        resolve_qp_backend("numba")


def test_qp_config_defaults_to_auto():
    assert QPSolverConfig().backend == "auto"


def test_pallas_width_limit_matches_kernel():
    # Resolution and the kernel share one limit: the widest k the
    # kernel's launch table covers.
    from convex_dim_red_tpu.ops.pallas_qp import launch_config
    assert launch_config(MAX_K)[0] == MAX_K
    with pytest.raises(ValueError):
        launch_config(MAX_K + 1)


def test_sharded_paths_resolve_auto(monkeypatch):
    # Off the GPU: 'auto' falls back to the portable XLA path.
    backend, _ = _weights_backend_kwargs({"backend": "auto"}, k=6)
    assert backend == "xla"
    # On the GPU the sharded fits take the fused kernel when k fits it.
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    backend, _ = _weights_backend_kwargs({"backend": "auto"}, k=6)
    assert backend == "pallas"
    backend, _ = _weights_backend_kwargs({"backend": "auto"},
                                         k=MAX_K + 1)
    assert backend == "xla"
    with pytest.raises(ValueError, match="unknown weights-QP backend"):
        _weights_backend_kwargs({"backend": "numba"})


def test_auto_batch_solve_matches_xla():
    rng = np.random.RandomState(0)
    k, n = 5, 37
    M = rng.standard_normal((k, k))
    A = jnp.asarray(M @ M.T + np.eye(k))
    B = jnp.asarray(rng.standard_normal((n, k)))
    X0 = jnp.full((n, k), 1.0 / k)
    auto = quad_simplex_spg_batch(A, B, X0, backend="auto")
    xla = quad_simplex_spg_batch(A, B, X0, backend="xla")
    np.testing.assert_allclose(np.asarray(auto), np.asarray(xla))


def test_aa_fit_accepts_auto_backend():
    rng = np.random.RandomState(1)
    X = rng.standard_normal((40, 7))
    model = ArchetypalAnalysis(
        n_components=3, max_iterations=30, tolerance=1e-8,
        random_state=0, weights_solver_kwargs={"backend": "auto"})
    model.fit(X)
    assert np.isfinite(model.cost)
