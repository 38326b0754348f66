"""Tests for the SPG solvers.

Ports the reference SPG contract (reference tests/test_spg.py:13-91) and
adds KKT checks for the batched simplex QP solver.
"""

import numpy as np
import jax.numpy as jnp

from convex_dim_red_tpu.ops.simplex_projection import (
    simplex_project_rows)
from convex_dim_red_tpu.solvers.spg import (
    spg, quad_simplex_spg, quad_simplex_spg_batch)


def test_correct_solution_on_unconstrained_1d_trivial_problem():
    tolerance = 1e-10
    max_iterations = 100
    max_feval = 100

    f = lambda x: x * x
    df = lambda x: 2.0 * x

    x0 = np.random.RandomState(0).uniform(-10.0, 10.0)

    x, f_min, n_iter, n_feval = spg(
        f, df, x0, max_iterations=max_iterations, max_feval=max_feval)

    assert abs(float(x)) < tolerance
    assert abs(float(f_min)) < tolerance
    assert int(n_iter) < max_iterations
    assert int(n_feval) < max_feval


def test_correct_solution_on_constrained_1d_trivial_problem():
    """Quartic with local min at x=0, global min at x=2, box [-1, 0.5]."""
    tolerance = 1e-6
    max_iterations = 100
    max_feval = 100

    a, b, c, d, e = 1.0, -15.0 / 4.0, 13.0 / 4.0, 0.0, 1.0

    f = lambda x: a * x ** 4 + b * x ** 3 + c * x ** 2 + d * x + e
    df = lambda x: 4 * a * x ** 3 + 3 * b * x ** 2 + 2 * c * x + d
    project = lambda x: jnp.clip(x, -1.0, 0.5)

    rng = np.random.RandomState(1)
    for x0 in (rng.uniform(1.1, 3.0), rng.uniform(-5.0, -2.0)):
        x, f_min, n_iter, n_feval = spg(
            f, df, x0, project=project,
            max_iterations=max_iterations, max_feval=max_feval)

        assert abs(float(x)) < tolerance
        assert abs(float(f_min) - 1.0) < tolerance
        assert int(n_iter) < max_iterations
        assert int(n_feval) < max_feval


def test_spg_on_matrix_variable_with_row_simplex_projection():
    # min ||X - T||^2 with T outside the feasible set; solution is the
    # row-wise projection of T.
    rng = np.random.RandomState(2)
    T = rng.standard_normal((4, 6))

    f = lambda X: jnp.sum((X - T) ** 2)
    df = lambda X: 2.0 * (X - T)

    X0 = np.full((4, 6), 1.0 / 6.0)
    X, f_min, n_iter, _ = spg(f, df, X0, project=simplex_project_rows,
                              epsilon_two=1e-12, max_iterations=500)

    expected = np.asarray(simplex_project_rows(T))
    assert np.allclose(np.asarray(X), expected, atol=1e-8)


def test_quad_simplex_spg_identity_hessian():
    # min 1/2 x'x - e1'x over simplex -> x = e1.
    A = np.eye(3)
    b = np.array([-1.0, 0.0, 0.0])
    x = np.asarray(quad_simplex_spg(A, b, np.ones(3) / 3))
    assert np.allclose(x, [1.0, 0.0, 0.0], atol=1e-8)


def test_quad_simplex_spg_interior_solution():
    # With A = I and b = 0 the minimizer over the simplex is the centroid.
    n = 5
    A = np.eye(n)
    b = np.zeros(n)
    rng = np.random.RandomState(3)
    x0 = rng.uniform(size=n)
    x0 /= x0.sum()
    x = np.asarray(quad_simplex_spg(A, b, x0))
    assert np.allclose(x, np.full(n, 1.0 / n), atol=1e-7)


def test_quad_simplex_spg_batch_kkt():
    rng = np.random.RandomState(0)
    k, n = 7, 64
    M = rng.standard_normal((k, k))
    A = M @ M.T + np.eye(k)
    B = rng.standard_normal((n, k))
    X0 = np.full((n, k), 1.0 / k)

    X = np.asarray(quad_simplex_spg_batch(A, B, X0))

    # Feasibility.
    assert np.allclose(X.sum(axis=1), 1.0, atol=1e-12)
    assert (X >= -1e-14).all()

    # Projected-gradient residual below solver tolerance for each row.
    G = X @ A + B
    res = np.asarray(simplex_project_rows(X - G)) - X
    assert np.abs(res).max() < 2e-6

    # Batch matches row-by-row solves.
    for t in range(0, n, 17):
        xt = np.asarray(quad_simplex_spg(A, B[t], X0[t]))
        assert np.allclose(X[t], xt, atol=1e-12)


def test_quad_simplex_spg_batch_monotone_cost():
    rng = np.random.RandomState(5)
    k, n = 4, 32
    M = rng.standard_normal((k, k))
    A = M @ M.T
    B = rng.standard_normal((n, k))
    X0 = rng.uniform(size=(n, k))
    X0 /= X0.sum(axis=1, keepdims=True)

    def total_cost(X):
        return float(np.sum(0.5 * np.einsum('ij,jk,ik->i', X, A, X)
                            + np.sum(X * B, axis=1)))

    X = np.asarray(quad_simplex_spg_batch(A, B, X0))
    assert total_cost(X) <= total_cost(X0) + 1e-12


# ---------------------------------------------------------------------------
# Soft-failure warnings (reference spg.py:225-229, :271-276, :278-281)
# ---------------------------------------------------------------------------


def test_spg_warns_on_max_iterations():
    import pytest
    f = lambda x: jnp.sum(x * x)
    df = lambda x: 2.0 * x
    x0 = np.full((4,), 10.0)
    with pytest.warns(UserWarning,
                      match='maximum number of iterations exceeded'):
        spg(f, df, x0, max_iterations=1, epsilon_one=1e-300,
            epsilon_two=1e-300)


def test_spg_warns_on_max_feval():
    import pytest
    # Rosenbrock-like: needs many evaluations; max_feval trips first.
    f = lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                          + (1.0 - x[:-1]) ** 2)

    def df(x):
        g = jnp.zeros_like(x)
        g = g.at[:-1].set(-400.0 * x[:-1] * (x[1:] - x[:-1] ** 2)
                          - 2.0 * (1.0 - x[:-1]))
        g = g.at[1:].add(200.0 * (x[1:] - x[:-1] ** 2))
        return g

    x0 = np.array([-1.2, 1.0, -1.2, 1.0])
    with pytest.warns(UserWarning,
                      match='maximum number of function evaluations'):
        spg(f, df, x0, max_iterations=10000, max_feval=5,
            epsilon_one=1e-300, epsilon_two=1e-300)


def test_spg_warns_on_line_search_underflow():
    import pytest
    # A wrong-sign gradient makes every step an ascent direction: the
    # nonmonotone line search can never satisfy the Armijo condition and
    # shrinks lambda below lambda_min.
    f = lambda x: jnp.sum(x * x)
    df = lambda x: -2.0 * x
    x0 = np.full((3,), 5.0)
    with pytest.warns(UserWarning, match='step size below tolerance'):
        spg(f, df, x0, max_iterations=2, lambda_min=1e-2,
            epsilon_one=1e-300, epsilon_two=1e-300)


def test_spg_verbose_prints_reference_table(capsys):
    f = lambda x: jnp.sum(x * x)
    df = lambda x: 2.0 * x
    x0 = np.full((2,), 3.0)
    import jax
    x, f_min, n_iter, n_feval = spg(f, df, x0, verbose=1,
                                    max_iterations=50)
    jax.effects_barrier()
    out = capsys.readouterr().out
    lines = out.splitlines()
    # Header columns of the reference table (spg.py:159-164).
    assert lines[0].split('|')[0].strip() == 'n_iter'
    assert 'conv_crit' in lines[0] and 'time' in lines[0]
    assert lines[1] == '-' * 79
    # Zeroth row has conv_crit == -1 (reference spg.py:162-164).
    assert '-1.000000e+00' in lines[2]
    # Converged footer (reference spg.py:263-266).
    assert any('*** Converged at iteration' in ln for ln in lines)
