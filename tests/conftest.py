import os

import pytest

# The suite runs on an 8-device virtual CPU mesh so that the multi-device
# sharding paths are exercised without accelerators.  A run that names its
# platforms (JAX_PLATFORMS=cuda,cpu for the `gpu`-marked tests on a card)
# keeps them.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import smcpp_jax  # noqa: E402,F401  (enables x64)


@pytest.fixture
def gpu_device():
    "The first CUDA device; skips the test where there is none."
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return devs[0]


@pytest.fixture(scope="session")
def example_vcf(tmp_path_factory):
    """Seeded 1 Mbp VCF: 10 diploids msp_0..msp_9 in two populations
    (data/simulate.py:write_example_vcf)."""
    from smcpp_jax.data.simulate import write_example_vcf

    return write_example_vcf(
        str(tmp_path_factory.mktemp("vcf") / "example.vcf.gz")
    )
