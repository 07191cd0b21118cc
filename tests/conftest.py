"""Test configuration.

Runs the suite on a virtual 8-device CPU mesh (the reference has no
distributed tests — SURVEY.md §4 marks this as our gap to fill) with
x64 enabled so the f64/c128 dtype sweeps match the reference's
tolerances. The platform goes through jax.config before any backend
initializes, so the suite stays on the CPU even on a machine with a GPU
(tests that need the card carry the ``gpu`` marker and run there).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound live-executable memory: the full suite runs ~500 jit
    compilations in one process; dropping the compilation caches at
    module boundaries keeps the live-executable count per-module
    (cross-module cache hits are rare — modules use distinct problem
    shapes — so the recompile cost is negligible). NOTE the suite's
    historical native crashes were NOT this — they were XLA's CPU
    in-process collective rendezvous LOG(FATAL)ing under deep unsynced
    dispatch queues (see SolverIterable's backpressure);
    this fixture just keeps memory flat on top of that fix."""
    yield
    jax.clear_caches()
