"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding correctness is validated on XLA's host platform with 8 virtual
devices (the analog of the reference's real-cluster-only MPI tests,
SURVEY.md §4).  Tests that need a GPU carry the ``gpu`` marker and skip on
the CPU; on the card, ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu
-n 0`` runs them, and chip_smoke.py runs the end-to-end checks.
"""

import os
import pathlib
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` need the card."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the "
                    "end-to-end checks on the card")
    return dev
