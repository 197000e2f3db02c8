"""Engine auto-selection (runtime.pick_engine): the deployment default
must never lose to its own host fallback. On the CPU test backend the
probe short-circuits to host; env pins and the legacy PANDASEQ_TPU_HOST
override take priority; the CLI logs the choice in its provenance lines
(args.c:515-531 analogue)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def test_pick_engine_cpu_backend_shortcuts_to_host(monkeypatch):
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE", raising=False)
    from pandaseq_tpu.runtime import pick_engine
    eng, info = pick_engine()
    assert eng == "host"
    assert info["reason"] == "cpu-backend"


def test_pick_engine_env_pin(monkeypatch):
    from pandaseq_tpu.runtime import pick_engine
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "device")
    assert pick_engine()[0] == "device"
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    assert pick_engine()[0] == "host"


def test_assembler_engine_priority(monkeypatch):
    from pandaseq_tpu.assembler import BatchAssembler

    # constructor pin wins over everything
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    asm = BatchAssembler(host_only=False)
    assert asm.engine == "device"
    assert asm.engine_info["reason"] == "constructor"

    # PANDASEQ_TPU_ENGINE beats the legacy var
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "1")
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "device")
    asm = BatchAssembler()
    assert asm.engine == "device"

    # legacy var still honored when ENGINE is unset
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE", raising=False)
    asm = BatchAssembler()
    assert asm.engine == "host"

    # auto on the CPU backend resolves to host via the probe shortcut
    monkeypatch.delenv("PANDASEQ_TPU_HOST", raising=False)
    asm = BatchAssembler()
    assert asm.engine == "host"
    assert asm.engine_info["reason"] == "cpu-backend"


def test_cli_logs_engine_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pandaseq_tpu.cli.main", "-T", "1",
         "-f", os.path.join(DATA, "synth_1.fastq"),
         "-r", os.path.join(DATA, "synth_2.fastq")],
        capture_output=True, cwd=ROOT, env=env, timeout=600)
    assert b"INFO\tENGINE\t" in r.stderr
