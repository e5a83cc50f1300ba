"""Test environment.

By default the suite runs on the CPU with 8 virtual devices, so mesh and
sharding tests run anywhere. ``JAX_PLATFORMS`` set by the caller wins:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the card-only
tests (marker ``gpu``) on a CUDA GPU. Must run before the first
``import jax`` anywhere in the test process."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


REFERENCE_FIXTURES = "/root/reference/Code/CUDA/FinalProject/build/step3"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (compiled kernels); skipped elsewhere"
    )


@pytest.fixture
def gpu():
    """Skip unless the default backend is a CUDA GPU (decided at run time,
    never at import or collection time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: the kernel has no CPU lowering")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Let ``engine="pallas"`` (and ``"auto"``) take the fused dual kernel
    on the CPU, in Pallas interpret mode: the routing seam reports a GPU
    and ``kernels.dual_loop`` interprets. Exercises the whole
    ``solve_batch`` path around the kernel; the arithmetic inside is the
    same kernel body the GPU compiles."""
    import functools

    from tpu_gpad.solver import kernels

    monkeypatch.setattr(kernels, "on_gpu", lambda: True)
    monkeypatch.setattr(
        kernels, "dual_loop",
        functools.partial(kernels.dual_loop, interpret=True),
    )
    jax.clear_caches()  # drop traces routed before the patch
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Clear the in-process jit/compile caches after every test module.

    The XLA:CPU backend has segfaulted inside backend_compile_and_load
    when the full suite's ~450 compiled executables accumulate in one
    process (the module passes alone and in every sub-suite tried; RSS
    was only ~4.4 GB, so not OOM). Dropping the caches at module
    boundaries bounds the live-executable count at a small recompile
    cost.
    """
    yield
    jax.clear_caches()
