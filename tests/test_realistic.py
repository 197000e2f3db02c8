"""Realistic-regime golden tests: harsh MiSeq artifacts (dense B-cliff
tails, mid-read N runs, short amplicons forcing read-through) and
PHRED+64 quality encoding, byte-compared against the reference binary
(the role of the McBath regression pair, testing/reg-test.vala:24)."""

import os
import subprocess
import sys

import pytest

from tests.test_oracle_golden import REF_BIN, _diff_head, _ensure_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)

H1 = os.path.join(DATA, "harsh_1.fastq")
H2 = os.path.join(DATA, "harsh_2.fastq")
P641 = os.path.join(DATA, "p64_1.fastq")
P642 = os.path.join(DATA, "p64_2.fastq")


def _gen(prefix, extra):
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "golden",
                                      "make_data.py"),
         "--pairs", "250", "--seed", "1234", "--out-prefix",
         os.path.join(DATA, prefix), *extra],
        check=True, cwd=ROOT, stdout=subprocess.DEVNULL)


def _ensure_data():
    _ensure_ref()
    if not os.path.exists(H1):
        # harsh: half the reads end in a B-cliff, a third carry an N
        # run, amplicons down to 220 bp (overlap > read length =>
        # read-through / wedge reconstruction cases)
        _gen("harsh", ["--cliff-rate", "0.5", "--n-run-rate", "0.35",
                       "--amp-min", "220", "--amp-max", "470"])
    if not os.path.exists(P641):
        _gen("p64", ["--qual-offset", "64", "--cliff-rate", "0.4",
                     "--n-run-rate", "0.2"])


def run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "pandaseq_tpu.cli.main", *args],
        capture_output=True, env=ENV, cwd=ROOT, timeout=300)


def run_ref(args):
    return subprocess.run([REF_BIN, "-T", "1", *args],
                          capture_output=True)


@pytest.mark.parametrize("extra", [
    [], ["-F"], ["-A", "pear"], ["-A", "rdp_mle"], ["-A", "stitch"],
    ["-A", "ea_util"],
])
def test_harsh_dataset_bit_identical(extra):
    _ensure_data()
    base = ["-f", H1, "-r", H2]
    ref = run_ref(base + extra)
    got = run_cli(base + extra)
    assert ref.stdout, "reference produced no output"
    assert got.stdout == ref.stdout, _diff_head(ref.stdout, got.stdout)
    assert got.returncode == ref.returncode


@pytest.mark.parametrize("extra", [["-6"], ["-6", "-F"]])
def test_phred64_bit_identical(extra):
    _ensure_data()
    base = ["-f", P641, "-r", P642]
    ref = run_ref(base + extra)
    got = run_cli(base + extra)
    assert ref.stdout, "reference produced no output"
    assert got.stdout == ref.stdout, _diff_head(ref.stdout, got.stdout)


def test_million_pair_soak():
    """Opt-in large-scale soak (PSQ_SOAK=1): sha256 byte-equality with
    the reference over the ~1M-pair mega dataset, simple_bayesian and
    rdp_mle (the two here keep the opt-in run short). Regenerate the dataset with
    tests/golden/make_data.py --pairs 1048576 --out-prefix
    tests/data/mega."""
    import hashlib
    import subprocess

    if not os.environ.get("PSQ_SOAK"):
        pytest.skip("set PSQ_SOAK=1 (runs ~1M pairs; needs mega data)")
    f1 = os.path.join(DATA, "mega_1.fastq")
    f2 = os.path.join(DATA, "mega_2.fastq")
    if not (os.path.exists(f1) and os.path.exists(f2)):
        pytest.skip("mega dataset not generated")
    from pandaseq_tpu import oracle
    from pandaseq_tpu.assembler import BatchAssembler
    from pandaseq_tpu.io import native
    from pandaseq_tpu.io.prefetch import prefetch

    for algo in ("simple_bayesian", "rdp_mle"):
        args = [REF_BIN, "-T", "1", "-f", f1, "-r", f2]
        if algo != "simple_bayesian":
            args[1:1] = ["-A", algo]
        href = hashlib.sha256(
            subprocess.run(args, capture_output=True).stdout).hexdigest()
        cfg = oracle.OracleConfig() if algo == "simple_bayesian" else \
            oracle.OracleConfig(algorithm=oracle.make_algorithm(algo))
        asm = BatchAssembler(cfg, L=512)
        h = hashlib.sha256()

        def batches():
            yield from native.NativeBatchReader(f1, f2, batch=8192,
                                                L=512)
        for _, codes, payload in asm.emit_stream(
                prefetch(asm.pre_stream(batches())), depth=3,
                threaded=True):
            h.update(payload)
        assert h.hexdigest() == href, algo
