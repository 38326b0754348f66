"""Shared model plumbing: solver configs and stopping criteria.

The reference threads nested ``**kwargs`` dicts from estimator
constructors into the inner solvers with per-key ``.get`` defaults
(reference archetypal_analysis.py:369-396).  Here those become frozen
(hashable) dataclasses so they can be jit static arguments.
"""

from dataclasses import dataclass, fields

__all__ = [
    "QPSolverConfig",
    "SPGSolverConfig",
    "make_config",
    "STOPPING_CRITERIA",
    "has_converged",
    "prepare_estimator_mesh",
]


@dataclass(frozen=True)
class QPSolverConfig:
    """Parameters of the simplex-QP SPG solver (reference spg.py:286-291).

    ``backend``: 'pallas' routes batched solves to the fused GPU kernel
    (ops/pallas_qp.py), 'xla' to the portable vmapped solver, and the
    default 'auto' picks per call regime from measurement — 'pallas'
    on the GPU for cold one-shot batches (transforms) and the
    restart-batched fits, 'xla' for the warm-started QPs inside
    single-restart fit loops and on every other platform
    (solvers/spg.py:resolve_qp_backend has the measured numbers).
    """
    backend: str = 'auto'
    gamma: float = 1e-4
    memory: int = 1
    sigma_one: float = 0.1
    sigma_two: float = 0.9
    lambda_min: float = 1e-10
    alpha0: float = -1.0
    alpha_min: float = 1e-5
    alpha_max: float = 1e3
    epsilon_one: float = 1e-10
    epsilon_two: float = 1e-6
    max_iterations: int = 1000
    max_feval: int = 2000

    def kwargs(self):
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name != 'backend'}


@dataclass(frozen=True)
class SPGSolverConfig:
    """Parameters of the generic SPG solver (reference spg.py:46-51)."""
    gamma: float = 1e-4
    memory: int = 1
    sigma_one: float = 0.1
    sigma_two: float = 0.9
    lambda_min: float = 1e-10
    alpha0: float = None
    alpha_min: float = 1e-5
    alpha_max: float = 1e3
    epsilon_one: float = 1e-10
    epsilon_two: float = 1e-6
    use_infinity_norm: bool = True
    max_iterations: int = 10000
    max_feval: int = 1000000

    def kwargs(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def make_config(cls, kwargs):
    """Build a solver config from a reference-style kwargs dict.

    Unknown keys are rejected so typos surface instead of silently
    falling back to defaults.
    """
    if kwargs is None:
        return cls()
    if isinstance(kwargs, cls):
        return kwargs
    valid = {f.name for f in fields(cls)}
    unknown = set(kwargs) - valid
    if unknown:
        raise ValueError(
            'Unknown solver parameters %r; valid keys: %r'
            % (sorted(unknown), sorted(valid)))
    return cls(**kwargs)


def prepare_estimator_mesh(mesh, n_samples, whom, dim_name='n_samples',
                           single_fit=True):
    """Normalize and validate a ``mesh=`` given to an estimator.

    Most estimators run a SINGLE fit, so every device goes on the
    sample axis: a 1-D mesh is lifted to ``(1, n_devices)`` and a 2-D
    mesh must have a restart axis of size 1 (multi-restart sharding
    lives in ``parallel.aa_fit_restarts`` / ``parallel.sharded_aa_fit``)
    — pass ``single_fit=False`` for estimators with an internal restart
    batch (KMeans ``n_init``).  The sample axis must divide
    ``n_samples`` (``shard_map`` constraint).
    """
    # Deferred import: parallel imports models (solver configs), so a
    # top-level import here would be circular.
    from ..parallel.mesh import ensure_mesh_axes

    mesh = ensure_mesh_axes(mesh)
    n_restart_shards = mesh.shape['restarts']
    if single_fit and n_restart_shards != 1:
        raise ValueError(
            "%s: estimator-level mesh= runs one fit, so the 'restarts' "
            "mesh axis must have size 1 (got %d); shard multi-restart "
            "fits with parallel.aa_fit_restarts / parallel.sharded_*_fit"
            % (whom, n_restart_shards))
    n_shards = mesh.shape['samples']
    if n_samples % n_shards:
        raise ValueError(
            "%s: %s (%d) must be divisible by the mesh sample "
            "axis (%d devices); pad or subset the data, or use a "
            "smaller mesh" % (whom, dim_name, n_samples, n_shards))
    return mesh


STOPPING_CRITERIA = ('abs_delta_f', 'rel_delta_f')


def has_converged(old_cost, new_cost, tolerance, criterion):
    """Stopping test; parity with reference ``_get_stopping_criteria``
    (archetypal_analysis.py:177-197).  ``criterion`` must be static."""
    import jax.numpy as jnp

    if criterion == 'abs_delta_f':
        return jnp.abs(new_cost - old_cost) < tolerance
    if criterion == 'rel_delta_f':
        max_cost = jnp.maximum(jnp.abs(new_cost), jnp.abs(old_cost))
        return jnp.abs((new_cost - old_cost) / max_cost) < tolerance
    raise ValueError("unsupported stopping criterion '%s'" % criterion)
