"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests validate numerics and sharding on the CPU so they run anywhere;
tests that need the GPU are marked ``chip`` and skip here (run them on
the card with ``python -m pytest -m chip tests/``). pytest's plugin
autoloading can import jax before this file runs, so the platform is
forced through jax.config as well as the environment.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:  # also when a plugin imported jax before XLA_FLAGS was set
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass

# keep the suite exercising the DEVICE kernel path on CPU XLA: the
# engine's auto host-only mode (assembler.py) would otherwise route the
# sparse path through the native host twin. Host-only mode has its own
# explicit tests (tests/test_host_mode.py sets PANDASEQ_TPU_HOST=1).
os.environ.setdefault("PANDASEQ_TPU_HOST", "0")

import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session", autouse=True)
def _synth_data():
    """Regenerate the gitignored synthetic dataset if the workspace was
    cleaned; several modules read tests/data/synth_*.fastq directly."""
    f1 = os.path.join(_ROOT, "tests", "data", "synth_1.fastq")
    if not os.path.exists(f1):
        subprocess.run(
            [sys.executable,
             os.path.join(_ROOT, "tests", "golden", "make_data.py"),
             "--out-prefix", os.path.join(_ROOT, "tests", "data", "synth")],
            check=True, cwd=_ROOT)
