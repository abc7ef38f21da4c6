"""Test harness.

By default the tests run JAX on a virtual 8-device CPU mesh, so the
sharding paths compile and execute without an accelerator.  Tests that
need the card carry the ``gpu`` marker; ``pytest -m gpu`` leaves JAX on
its default platform for them (see README)."""
import os


def pytest_configure(config):
    if config.getoption("markexpr", "") == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from downpore_tpu.cli.main import enable_compile_cache
    enable_compile_cache()
