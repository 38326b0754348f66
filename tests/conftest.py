"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled so the
reference package's property-test tolerances (1e-12 fixed points,
1e-14/1e-15 feasibility; see the reference's tests/) can be asserted
exactly.  The production GPU path runs the same code in float32.
``JAX_PLATFORMS`` defaults to ``cpu``; tests marked ``gpu`` reach the
card when it is set to ``cuda``.

The environment variables must be set before JAX initializes its
backends, hence the os.environ writes at import time.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
