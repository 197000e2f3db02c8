"""chip_smoke.py: refuses to run without a GPU, and its checks hold on
the CPU at a small batch (the kernels against the native host twin, the
dense shortlist kernels against the oracle and the f64 LUT reference).
The full run needs the card: ``python -m pytest -m chip tests/``."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _batch(B):
    from pandaseq_tpu.io import native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    return chip_smoke.first_batch(os.path.join(DATA, "synth_1.fastq"),
                                  os.path.join(DATA, "synth_2.fastq"), B)


def test_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_candidate_kernels_match_host_twin_b64():
    times = chip_smoke.check_candidate_kernels(_batch(64), reps=1)
    assert {"list", "mask", "join", "pack_bits16"} <= set(times)


def test_dense_kernels_match_oracle_b64():
    times = chip_smoke.check_dense_kernels(_batch(64), sample=16,
                                           lut_rows=16, reps=1)
    assert len(times) == 3


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA card answers nvidia-smi (decided when the
    test runs, never at import)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True
                                     ).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.chip
def test_chip_smoke_on_gpu(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
