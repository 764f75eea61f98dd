"""Test configuration: run everything on a virtual 8-device CPU mesh.

Per SURVEY.md §4: multi-device behavior is validated with
``xla_force_host_platform_device_count`` (no accelerator needed in CI);
float64 is enabled so assembly/solver numerics can be checked against f64
ground truth (the reference's OSQP path is f64).  The platform is pinned
through ``jax.config`` so the suite runs on the CPU whatever
``JAX_PLATFORMS`` says.

Tests that need a CUDA GPU carry the ``gpu`` marker and skip elsewhere
(decided in the ``gpu`` fixture, never at import time).  On a machine with
a card, run them with ``OSQP_GPU_TESTS=1 python -m pytest tests -m gpu``;
``python chip_smoke.py`` runs the same checks at full width.
"""
import functools
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("OSQP_GPU_TESTS"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless the default JAX platform is a CUDA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (OSQP_GPU_TESTS=1 on a machine with one)")


@pytest.fixture
def interpret_chunk_kernel(monkeypatch):
    """Route the lane driver's ADMM chunks through the fused Triton kernel,
    run by the Pallas interpreter: the backend module sees a GPU, and every
    kernel call gets ``interpret=True`` (with a 16-problem tile, so small
    test batches still span several programs)."""
    from osqp_solver_tpu.ops import admm_fused, backend

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(
        admm_fused,
        "fused_admm_chunk",
        functools.partial(
            admm_fused.fused_admm_chunk, interpret=True, block_b=16
        ),
    )


@pytest.fixture(autouse=True, scope="module")
def _clear_compiled_programs_between_modules():
    """Release compiled executables after each test module.

    The full suite compiles thousands of XLA:CPU programs; with every
    executable kept alive the accumulated compiler/runtime state ends in a
    deterministic SEGFAULT inside ``backend_compile_and_load`` about 135
    tests in (reproducible at the identical test in two clean full-suite
    runs, NOT reproducible for any file subset).  Dropping the jit caches
    between modules keeps the live-program count bounded; cross-module
    recompiles cost a few extra minutes.
    """
    yield
    jax.clear_caches()
