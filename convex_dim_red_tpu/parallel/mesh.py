"""Device-mesh helpers for multi-chip runs.

The reference has no distributed backend (single-process CPU package;
SURVEY.md §2.4); scaling in this framework is built on
``jax.sharding.Mesh``.  The cards of one host are joined all to all
(NVLink), so the mesh follows the algorithm alone and
:func:`create_mesh` is the one constructor.  The two parallel axes that
exist in this problem domain:

- ``restarts``: independent multi-restart fits (data-parallel analog) —
  the reference runs these serially (bin/run_hadisst_aa.py:158-174).
- ``samples``: rows of the data/kernel matrix (tensor/sequence-parallel
  analog) — Gram formation and the per-row weight QPs shard over it,
  with ``psum``/``all_gather`` for the k-sized reductions.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["create_mesh", "ensure_mesh_axes", "replicate", "shard_batch",
           "P", "NamedSharding"]


def create_mesh(shape=None, axis_names=("restarts", "samples"),
                devices=None):
    """Create a mesh over the available devices.

    ``shape=None`` puts all devices on the first axis.  For a 2-D mesh
    pass e.g. ``shape=(4, 2)``.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    mesh_devices = np.asarray(devices).reshape(shape)
    return Mesh(mesh_devices, axis_names)


def ensure_mesh_axes(mesh, restart_axis="restarts", sample_axis="samples"):
    """Return a mesh that has both parallel axes, lifting 1-D meshes.

    The SPMD fits shard over a ``(restart_axis, sample_axis)`` mesh.
    Estimator-level entry points accept any of:

    - a 2-D mesh already carrying both axes (returned unchanged);
    - a 1-D mesh over ``sample_axis`` (lifted to ``(1, n_devices)``);
    - a 1-D mesh over ``restart_axis`` (lifted to ``(n_devices, 1)``).
    """
    names = tuple(mesh.axis_names)
    if restart_axis in names and sample_axis in names:
        return mesh
    devices = np.asarray(mesh.devices).reshape(-1)
    if names == (sample_axis,):
        return Mesh(devices.reshape(1, -1), (restart_axis, sample_axis))
    if names == (restart_axis,):
        return Mesh(devices.reshape(-1, 1), (restart_axis, sample_axis))
    raise ValueError(
        "mesh must carry axes (%r, %r) or be 1-D over one of them; got "
        "axis_names=%r" % (restart_axis, sample_axis, names))


def replicate(mesh, x):
    """Place ``x`` replicated over every mesh axis."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_batch(mesh, x, axis_name="restarts"):
    """Shard the leading axis of ``x`` over ``axis_name``."""
    spec = P(axis_name, *([None] * (np.ndim(x) - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))
