"""Correctness tests for the fused weights-QP kernel (ops/pallas_qp.py).

On the CPU the kernel body runs in Pallas interpret mode; the tests
marked ``gpu`` compile it for the card and skip where there is none
(run them on the GPU with ``JAX_PLATFORMS=cuda python -m pytest -m
gpu tests/``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convex_dim_red_tpu.ops import pallas_qp
from convex_dim_red_tpu.ops.pallas_qp import (MAX_K, launch_config,
                                              quad_simplex_qp_pallas)
from convex_dim_red_tpu.ops.simplex_projection import (
    simplex_project_masked, simplex_project_rows)
from convex_dim_red_tpu.solvers.spg import (quad_simplex_spg_batch,
                                            quad_simplex_spg_batch_grouped)


def _problem(rng, n, k, scale=1.0, R=1):
    M = rng.standard_normal((R, k, k))
    A = M @ M.transpose(0, 2, 1) + np.eye(k)
    B = scale * rng.standard_normal((R, n, k))
    X0 = np.full((R, n, k), 1.0 / k)
    return A, B, X0


def _obj(X, A, B):
    return (0.5 * np.einsum('rij,rjk,rik->ri', X, A, X)
            + np.sum(X * B, axis=-1))


def _kernel(A, B, X0, **kw):
    return np.asarray(quad_simplex_qp_pallas(A, B, X0, interpret=True,
                                             **kw))


def _xla(A, B, X0, **kw):
    return np.asarray(quad_simplex_spg_batch_grouped(A, B, X0,
                                                     backend='xla', **kw))


# n is never a multiple of the block height and k is mostly not a power
# of two, so both the row and the component padding are exercised.
@pytest.mark.parametrize("R,n,k", [(1, 16, 11), (2, 33, 3), (3, 37, 5),
                                   (2, 9, 20)])
def test_pallas_matches_xla_objective(R, n, k):
    rng = np.random.RandomState(0)
    A, B, X0 = _problem(rng, n, k, R=R)

    Xp = _kernel(A, B, X0, max_iterations=500)
    Xx = _xla(A, B, X0, max_iterations=500)

    assert Xp.shape == (R, n, k)
    assert np.allclose(Xp.sum(axis=-1), 1.0, atol=1e-6)
    assert (Xp >= -1e-9).all()
    gap = _obj(Xp, A, B) - _obj(Xx, A, B)
    assert np.abs(gap).max() < 1e-6


def test_pallas_kkt_residual():
    rng = np.random.RandomState(1)
    A, B, X0 = _problem(rng, 48, 5)
    Xp = _kernel(A, B, X0, max_iterations=1000)[0]
    G = Xp @ A[0] + B[0]
    res = np.asarray(simplex_project_rows(Xp - G)) - Xp
    assert np.abs(res).max() < 1e-5


@pytest.mark.parametrize("k", [4, 11])
def test_pallas_padding_does_not_leak(k):
    # Padded rows and lanes must not affect real outputs: a batch must
    # match a solve of its leading rows alone.
    rng = np.random.RandomState(2)
    A, B, X0 = _problem(rng, 21, k)
    X_full = _kernel(A, B, X0, max_iterations=300)
    X_sub = _kernel(A, B[:, :8], X0[:, :8], max_iterations=300)
    assert np.allclose(X_full[:, :8], X_sub, atol=1e-12)


def test_pallas_rejects_oversized_k():
    k = MAX_K + 1
    with pytest.raises(ValueError, match="k <= %d" % MAX_K):
        quad_simplex_qp_pallas(np.eye(k)[None], np.zeros((1, 4, k)),
                               np.full((1, 4, k), 1.0 / k), interpret=True)


def test_pallas_off_gpu_needs_interpret():
    """A compiled call off the GPU raises instead of interpreting
    quietly."""
    assert jax.default_backend() == "cpu"
    rng = np.random.RandomState(3)
    A, B, X0 = _problem(rng, 8, 3)
    with pytest.raises(ValueError, match="only for the GPU"):
        quad_simplex_qp_pallas(A, B, X0)
    with pytest.raises(ValueError, match="only for the GPU"):
        quad_simplex_spg_batch(A[0], B[0], X0[0], backend='pallas')


def test_launch_config_pads_k_to_powers_of_two():
    for k, k_pad in [(1, 8), (6, 8), (8, 8), (9, 16), (20, 32),
                     (33, 64), (MAX_K, MAX_K)]:
        got_pad, rows, warps = launch_config(k)
        assert got_pad == k_pad
        assert rows >= 1 and rows & (rows - 1) == 0
        assert warps >= 1
    with pytest.raises(ValueError):
        launch_config(MAX_K + 1)


def test_grouped_matches_per_group_solves():
    """One launch over R Hessians equals R single-Hessian launches."""
    rng = np.random.RandomState(5)
    A, B, X0 = _problem(rng, 21, 6, R=3)
    Xg = _kernel(A, B, X0, max_iterations=500)
    for r in range(3):
        X1 = _kernel(A[r:r + 1], B[r:r + 1], X0[r:r + 1],
                     max_iterations=500)
        assert np.allclose(Xg[r], X1[0], atol=1e-12)


def test_single_hessian_dispatch_is_group_of_one():
    """quad_simplex_spg_batch(backend='pallas') is the grouped kernel
    with R = 1."""
    rng = np.random.RandomState(10)
    A, B, X0 = _problem(rng, 16, 4)
    out = np.asarray(quad_simplex_spg_batch(
        A[0], B[0], X0[0], backend='pallas', interpret=True,
        max_iterations=400))
    assert out.shape == (16, 4)
    assert np.allclose(out, _kernel(A, B, X0, max_iterations=400)[0],
                       atol=1e-12)


@pytest.mark.parametrize("k,m,n", [(6, 4, 33), (20, 13, 17)])
def test_pallas_masked_matches_masked_xla(k, m, n):
    """Runtime component masks (padded-k bucketing): masked lanes pinned
    to exact zero, active block matching the masked XLA solve."""
    rng = np.random.RandomState(7)
    A, B, X0 = _problem(rng, n, k, R=2)
    mask = np.arange(k) < m
    Xp = _kernel(A, B, X0, max_iterations=800, mask=mask)
    Xx = _xla(A, B, X0, max_iterations=800, mask=jnp.asarray(mask))
    assert np.all(Xp[..., m:] == 0.0)
    assert np.allclose(Xp.sum(axis=-1), 1.0, atol=1e-6)
    gap = _obj(Xp, A, B) - _obj(Xx, A, B)
    assert np.abs(gap).max() < 1e-6


def test_pallas_all_true_mask_equals_no_mask():
    """An all-true mask must be exactly the unmasked solve (the
    exact-multiple-k bucketing path)."""
    rng = np.random.RandomState(8)
    A, B, X0 = _problem(rng, 24, 5)
    X_plain = _kernel(A, B, X0, max_iterations=400)
    X_mask = _kernel(A, B, X0, max_iterations=400, mask=np.ones(5, bool))
    assert np.allclose(X_plain, X_mask, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_projection_matches_sort_projection(masked):
    """With no SPG iteration the kernel returns its Michelot projection
    of the start, which must equal the sort-based simplex projection."""
    rng = np.random.RandomState(21)
    k = 7
    A, B, _ = _problem(rng, 19, k)
    X0 = 3.0 * rng.standard_normal((1, 19, k))
    mask = np.arange(k) < 4
    kw = {'mask': mask} if masked else {}
    Xm = _kernel(A, B, X0, max_iterations=0, **kw)[0]
    ref = (np.asarray(simplex_project_masked(X0[0], jnp.asarray(mask)))
           if masked else np.asarray(simplex_project_rows(X0[0])))
    assert np.allclose(Xm, ref, atol=1e-12)


def test_max_feval_caps_kernel_iterations():
    """``max_feval`` caps the fused solve as it caps the XLA solver
    (quad_simplex_spg uses min(max_iterations, max_feval))."""
    rng = np.random.RandomState(22)
    A, B, X0 = _problem(rng, 12, 5, scale=5.0)
    capped = np.asarray(quad_simplex_spg_batch_grouped(
        A, B, X0, backend='pallas', interpret=True, max_iterations=500,
        max_feval=2))
    assert np.allclose(capped, _kernel(A, B, X0, max_iterations=2),
                       atol=1e-12)


@pytest.fixture
def gpu_device():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("R,n,k,m", [(25, 1788, 6, 6), (10, 900, 20, 20),
                                     (25, 1788, 8, 6), (2, 1788, MAX_K,
                                                        MAX_K)])
def test_compiled_kernel_matches_xla_on_gpu(gpu_device, R, n, k, m):
    """The compiled kernel at real widths, in float32 on the card,
    against the XLA solver there (objectives in float64)."""
    rng = np.random.RandomState(31)
    A, B, X0 = _problem(rng, n, k, R=R)
    mask = np.arange(k) < m
    with jax.default_device(gpu_device):
        args = [jnp.asarray(v, jnp.float32) for v in (A, B, X0)]
        solve = jax.jit(lambda A, B, X0, mask, backend:
                        quad_simplex_spg_batch_grouped(
                            A, B, X0, backend=backend, mask=mask),
                        static_argnums=4)
        Xp = np.asarray(solve(*args, jnp.asarray(mask), 'pallas'),
                        np.float64)
        Xx = np.asarray(solve(*args, jnp.asarray(mask), 'xla'),
                        np.float64)
    assert np.abs(Xp.sum(axis=-1) - 1.0).max() < 1e-5
    assert np.all(Xp[..., m:] == 0.0)
    assert (_obj(Xp, A, B) - _obj(Xx, A, B)).max() < 1e-4


def test_module_exports():
    assert set(pallas_qp.__all__) == {"quad_simplex_qp_pallas", "MAX_K",
                                      "launch_config"}
