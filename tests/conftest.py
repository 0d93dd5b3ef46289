"""Test configuration: the CPU backend with 8 virtual devices.

The tests run on the CPU, which gives the sharded paths a multi-device mesh
without hardware and keeps every test process off the GPU.  Tests marked
`gpu` run their checks in a child process that opens the card; the
`gpu_env` fixture skips them on machines without one.
"""

import os
import shutil
import subprocess

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process that runs on the GPU."""
    smi = shutil.which("nvidia-smi")
    listed = smi and subprocess.run(
        [smi, "-L"], capture_output=True, text=True
    ).stdout
    if not listed or "GPU" not in listed:
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = repo
    return env
