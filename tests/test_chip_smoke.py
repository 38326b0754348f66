"""The chip smoke test's float64 references and checks, at tiny sizes on
the CPU, and the benchmark's device requirements (chip_smoke.py,
bench.py, benchmarks/flops.py)."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from benchmarks.flops import PEAKS, peak_flops
from convex_dim_red_tpu import PCA
from convex_dim_red_tpu.models.archetypal_analysis import kernel_aa_cost
from convex_dim_red_tpu.models.gpnh_convex_coding import gpnh_cost
from convex_dim_red_tpu.solvers.spg import quad_simplex_spg_batch_grouped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stochastic(rng, shape):
    W = rng.uniform(size=shape)
    return W / W.sum(axis=-1, keepdims=True)


def test_check_qp_passes_solver_output_and_flags_faults():
    A, B, X0 = chip_smoke.qp_problem(2, 9, 5, seed=0)
    mask = np.arange(5) < 4
    X0 = np.where(mask, X0, 0.0) / 0.8
    X = np.asarray(quad_simplex_spg_batch_grouped(
        A, B, X0, backend='xla', mask=jnp.asarray(mask)))
    out = chip_smoke.check_qp(X, X, A, B, mask=mask)
    assert out["objective_worse_max"] == 0.0
    assert out["masked_abs_max"] == 0.0
    assert out["row_sum_err"] < 1e-12

    leaky = X.copy()
    leaky[0, 0, 4] = 1e-9
    with pytest.raises(SystemExit, match="masked"):
        chip_smoke.check_qp(leaky, X, A, B, mask=mask)
    with pytest.raises(SystemExit, match="row sums"):
        chip_smoke.check_qp(1.01 * X, X, A, B)
    worse = np.full_like(X, 0.2)
    with pytest.raises(SystemExit, match="objective"):
        chip_smoke.check_qp(worse, X, A, B)


def test_host_costs_match_library_costs():
    rng = np.random.RandomState(1)
    n, d, k = 23, 7, 3
    X = rng.standard_normal((n, d))
    Z = _stochastic(rng, (n, k))
    W = rng.standard_normal((d, k))
    assert chip_smoke.gpnh_cost_f64(X, Z, W, 1e-2) == pytest.approx(
        float(gpnh_cost(X, Z, W, lambda_W=1e-2)), rel=1e-12)

    K = X @ X.T
    C = _stochastic(rng, (k, n))
    alpha = np.array([0.9, 1.0, 1.1])
    assert chip_smoke.kernel_aa_cost_f64(K, Z, C, alpha) == pytest.approx(
        float(kernel_aa_cost(K, Z, C, alpha)), rel=1e-10)

    resid = Z @ C @ X - X
    assert bench.audit_cost_f64({'weights': Z, 'dictionary': C}, X) == \
        pytest.approx(0.5 * np.sum(resid ** 2) / n, rel=1e-12)


def test_kmeans_and_pca_references():
    rng = np.random.RandomState(2)
    X = rng.standard_normal((30, 12))
    centers = X[:3]
    labels = np.argmin(((X[:, None] - centers[None]) ** 2).sum(-1), axis=1)
    expect = sum(np.sum((X[i] - centers[labels[i]]) ** 2)
                 for i in range(30))
    assert chip_smoke.kmeans_inertia_f64(X, centers, labels) == \
        pytest.approx(expect, rel=1e-12)

    ref = chip_smoke.pca_variances_f64(X @ X.T, 4)
    pca = PCA(n_components=4).fit(X)
    assert chip_smoke.rel_err(pca.explained_variance_, ref) < 1e-10


def test_audit_and_stochastic_checks():
    assert chip_smoke.check_audit(100.0, 100.05, "x") < 1e-3
    with pytest.raises(SystemExit, match="audit"):
        chip_smoke.check_audit(100.0, 101.0, "x")
    with pytest.raises(SystemExit, match="audit"):
        chip_smoke.check_audit(float("nan"), 1.0, "x")
    W = _stochastic(np.random.RandomState(3), (5, 4))
    assert chip_smoke.check_stochastic(W, "x") < 1e-12
    with pytest.raises(SystemExit, match="row-stochastic"):
        chip_smoke.check_stochastic(1.001 * W, "x")


def test_device_phase_fails_without_gpu(capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.device_phase()
    assert '"ok"' not in capsys.readouterr().out


def test_bench_requires_gpu():
    from convex_dim_red_tpu.utils.precision import get_matmul_precision
    before = get_matmul_precision()
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.headline()
    assert get_matmul_precision() == before


def test_script_alone_fails_without_result(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository, the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_peak_table_knows_h100_and_rejects_unknown():
    kind = "NVIDIA H100 80GB HBM3"
    assert peak_flops(kind, "bfloat16") == 989e12
    assert peak_flops(kind, "tensorfloat32") == 495e12
    assert peak_flops(kind, "float32") == 67e12
    with pytest.raises(ValueError, match="no published peak"):
        peak_flops("cpu", "float32")
    with pytest.raises(ValueError, match="no published peak"):
        peak_flops(kind, "float64")
    assert set(PEAKS) == {kind}
