"""Test harness: force an 8-device virtual CPU platform so every
sharding/collective test exercises a real multi-device mesh
(SURVEY.md §4: the multi-device simulation the reference never had).

jax.config is used rather than environment variables so the settings hold
even if jax was imported before this file. The persistent compile cache is
switched off: the CLI entry points turn it on, and test workers should
neither read nor write it.

``RECSYS_CHIP_TESTS=1`` leaves JAX on its default platform, for the tests
marked ``chip``; on a machine with a GPU run
``RECSYS_CHIP_TESTS=1 python -m pytest tests/test_bring_up.py -m chip``.
Each of them checks for the GPU in a fixture.
"""

import os

import jax

if not os.environ.get("RECSYS_CHIP_TESTS"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU, or a skip where JAX sees none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {device.platform}")
    return device


@pytest.fixture(scope="session")
def mesh8():
    from recsys.config import MeshConfig
    from recsys.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(num_data=4, num_model=2))


@pytest.fixture(scope="session")
def mesh_dp():
    from recsys.config import MeshConfig
    from recsys.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(num_data=8, num_model=1))
