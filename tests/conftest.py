"""Test configuration.

The tests run on JAX's CPU backend (JAX_PLATFORMS=cpu, forced here), with
a virtual 8-device CPU mesh for the sharding tests, so they need no
accelerator. Tests marked `chip` need a GPU: they skip on the CPU and run
on the card through `python chip_smoke.py`. The persistent compilation
cache stays off so parallel test workers write nothing into the checkout.
Must set the XLA flags before jax is imported anywhere.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
try:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)
except ImportError:
    pass
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
