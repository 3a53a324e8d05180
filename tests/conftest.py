"""Test env: hermetic CPU backend with 8 virtual devices (SURVEY.md §5.2.3).

The same shard_map code path exercises the multi-host contract without a
GPU cluster. Must run before jax is imported anywhere. Tests marked
``gpu`` need an NVIDIA GPU: run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; elsewhere they skip.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test unless JAX's default device is a GPU —
    decided when the test runs, never at import or collection."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
