"""Device-offload lane for the host-engine pipeline (_DeviceOffload):
offloaded groups must produce byte-identical output to the pure host
path (both engines are exactness-anchored to the same candidate
semantics), and a lane timeout must fall back to the native twin
without changing a byte (the auto default must use all available
silicon without ever risking the host baseline)."""

import os

import numpy as np
import pytest

from pandaseq_tpu import oracle
from pandaseq_tpu.assembler import BatchAssembler, _DeviceOffload
from pandaseq_tpu.io import native

if native.get_lib() is None:  # pragma: no cover
    pytest.skip("native decoder unavailable", allow_module_level=True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F1 = os.path.join(ROOT, "tests", "data", "synth_1.fastq")
F2 = os.path.join(ROOT, "tests", "data", "synth_2.fastq")


def _run(monkeypatch, offload_env, timeout=None):
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", offload_env)
    if timeout is not None:
        monkeypatch.setattr(_DeviceOffload, "timeout",
                            lambda self: timeout)
    asm = BatchAssembler(oracle.OracleConfig(), L=512)
    rdr = native.NativeBatchReader(F1, F2, batch=256, L=512, ring=24)
    payload = b""
    codes = []
    for _, cs, pl in asm.emit_stream(rdr, fmt="fasta", depth=4,
                                     threaded=True, group=2):
        payload += pl
        codes.extend(cs)
    return payload, codes, asm


def test_offload_output_identical(monkeypatch):
    base, codes0, asm0 = _run(monkeypatch, "0")
    assert asm0._offload_count == 0
    got, codes1, asm1 = _run(monkeypatch, "force")
    assert asm1._offload_count > 0, "no group was offloaded"
    assert got == base
    assert codes1 == codes0


def test_offload_timeout_falls_back_to_host(monkeypatch):
    base, codes0, _ = _run(monkeypatch, "0")
    got, codes1, asm = _run(monkeypatch, "force", timeout=0.0)
    assert asm._offload_timeouts > 0, "timeout path never exercised"
    assert got == base
    assert codes1 == codes0


def test_offload_is_opt_in(monkeypatch):
    """Offload is opt-in until a measurement on the card shows it
    paying, so the default must stay the plain host engine."""
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    monkeypatch.delenv("PANDASEQ_TPU_OFFLOAD", raising=False)
    asm = BatchAssembler(oracle.OracleConfig(), L=512)
    assert not asm._offload_enabled()
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", "0")
    asm = BatchAssembler(oracle.OracleConfig(), L=512)
    assert not asm._offload_enabled()


def test_offload_requires_seeded_kmers(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", "force")
    asm = BatchAssembler(oracle.OracleConfig(num_kmers=0), L=512)
    assert not asm._offload_enabled()
    asm = BatchAssembler(oracle.OracleConfig(num_kmers=3), L=512)
    assert not asm._offload_enabled()
