"""convex_dim_red_tpu: convex matrix factorization on JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
``convex_dim_red`` package (archetypal analysis, GPNH convex coding,
k-means helpers, SPG solvers, simplex projections, FurthestSum
initialization) plus batching/sharding for multi-restart fits.

Public surface mirrors the reference package
(reference src/convex_dim_red/__init__.py:5-11) and adds the
parallel APIs.
"""

from .models.archetypal_analysis import ArchetypalAnalysis, KernelAA
from .models.gpnh_convex_coding import GPNHConvexCoding
from .models.kmeans import KMeans, gap_statistic, kmeans_fit
from .models.pca import PCA
from .ops.furthest_sum import furthest_sum, furthest_sum_device
from .ops.simplex_projection import (
    simplex_project,
    simplex_project_columns,
    simplex_project_masked,
    simplex_project_rows,
    simplex_project_vector,
)
from .utils.precision import get_matmul_precision, set_matmul_precision
from .ops.stochastic_matrices import (
    left_stochastic_matrix,
    right_stochastic_matrix,
)
from .parallel.restarts import aa_fit_restarts, gpnh_fit_restarts
from .solvers.spg import (quad_simplex_spg, quad_simplex_spg_batch,
                          quad_spg, resolve_qp_backend, spg)

__version__ = "0.1.0"

__all__ = [
    "ArchetypalAnalysis",
    "KernelAA",
    "GPNHConvexCoding",
    "KMeans",
    "PCA",
    "gap_statistic",
    "kmeans_fit",
    "furthest_sum",
    "furthest_sum_device",
    "simplex_project",
    "simplex_project_columns",
    "simplex_project_masked",
    "simplex_project_rows",
    "simplex_project_vector",
    "get_matmul_precision",
    "set_matmul_precision",
    "left_stochastic_matrix",
    "right_stochastic_matrix",
    "spg",
    "quad_spg",
    "quad_simplex_spg",
    "quad_simplex_spg_batch",
    "resolve_qp_backend",
    "aa_fit_restarts",
    "gpnh_fit_restarts",
]
