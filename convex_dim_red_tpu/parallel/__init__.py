"""Parallel layer: vmapped/sharded restarts, SPMD model fits, sweeps.

No reference analog (the reference is a single-process CPU package,
SURVEY.md §2.4); this is the framework's multi-device scaling layer.
"""

from .mesh import create_mesh, ensure_mesh_axes
from .restarts import (aa_fit_restarts, gpnh_fit_restarts,
                       kernel_aa_fit_restarts)
from .sharded_aa import (distributed_gram, sharded_aa_fit,
                         sharded_aa_train_step, sharded_gpnh_fit,
                         sharded_kernel_aa_fit)
from .sharded_models import (sharded_gap_statistic, sharded_kmeans_fit,
                             sharded_pca)
from .sweep import (aa_model_selection_sweep, gpnh_model_selection_sweep,
                    kmeans_model_selection_sweep)

__all__ = [
    "create_mesh", "ensure_mesh_axes",
    "aa_fit_restarts", "gpnh_fit_restarts", "kernel_aa_fit_restarts",
    "distributed_gram", "sharded_aa_train_step",
    "sharded_aa_fit", "sharded_kernel_aa_fit", "sharded_gpnh_fit",
    "sharded_kmeans_fit", "sharded_pca", "sharded_gap_statistic",
    "aa_model_selection_sweep", "gpnh_model_selection_sweep",
    "kmeans_model_selection_sweep",
]
