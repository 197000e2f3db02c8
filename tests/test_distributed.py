"""Distributed driver on a single process (virtual 8-device CPU mesh):
output equality with the single-stream path, counter psum, resume."""

import os

import numpy as np
import pytest

from tests.test_oracle_golden import F1, F2, ref_output


def test_run_distributed_single_host(tmp_path):
    from pandaseq_tpu.parallel import distributed

    counters, hist = distributed.run_distributed(
        [(F1, F2)], out_dir=str(tmp_path), batch=64)
    out = (tmp_path / "part-00000.fasta").read_bytes()
    assert out == ref_output([])
    # vector: count, ok, noalgn, lowq, badread, slow, nofp, norp
    assert counters[0] == 200
    assert counters[1] == int(out.count(b">"))
    assert sum(hist.values()) == counters[1]


def test_run_distributed_resume(tmp_path):
    from pandaseq_tpu.parallel import distributed

    ck = str(tmp_path / "ck.jsonl")
    distributed.run_distributed([(F1, F2)], out_dir=str(tmp_path),
                                batch=64, checkpoint=ck)
    first = (tmp_path / "part-00000.fasta").read_bytes()
    # resume immediately: everything is done, nothing gets appended
    distributed.run_distributed([(F1, F2)], out_dir=str(tmp_path),
                                batch=64, checkpoint=ck)
    assert (tmp_path / "part-00000.fasta").read_bytes() == first


def test_mux_round_robin_two_hosts(tmp_path, monkeypatch):
    """ONE input pair, two 'hosts' (PandaMux analogue, mux.c:132-161):
    each host claims alternating batches; the union of their outputs
    equals the single-host output and counters sum to the total."""
    from pandaseq_tpu.parallel import distributed

    ref = ref_output([])

    outs = []
    tot = np.zeros(8, dtype=np.int64)
    for rank in (0, 1):
        monkeypatch.setattr(distributed, "maybe_initialize_distributed",
                            lambda r=rank: (r, 2))
        counters, hist = distributed.run_distributed(
            [(F1, F2)], out_dir=str(tmp_path), batch=32)
        outs.append((tmp_path / ("part-%05d.fasta" % rank)).read_bytes())
        tot += counters
    assert tot[0] == 200  # every record processed exactly once
    # batch claims alternate, so interleaving the hosts' outputs
    # batch-by-batch reproduces the single-stream byte output
    assert len(outs[0]) + len(outs[1]) == len(ref)
    combined = sorted((outs[0] + outs[1]).split(b"\n"))
    assert combined == sorted(ref.split(b"\n"))


def test_shard_inputs():
    from pandaseq_tpu.parallel.distributed import shard_inputs

    inputs = [(f"f{i}", f"r{i}") for i in range(10)]
    a = shard_inputs(inputs, 0, 3)
    b = shard_inputs(inputs, 1, 3)
    c = shard_inputs(inputs, 2, 3)
    assert sorted(a + b + c) == sorted(inputs)
    assert len(a) == 4 and len(b) == 3 and len(c) == 3


def test_reduce_counters_direct():
    """reduce_counters: the per-process contribution rides the FIRST
    local device's row of a device-sharded array, so the device-axis
    sum is correct for any number of local devices per process. On the
    8-device virtual mesh the single process owns all 8 rows; the
    reduction must return exactly the one contribution."""
    from pandaseq_tpu.assembler import Counters
    from pandaseq_tpu.parallel.distributed import reduce_counters

    c = Counters(count=101, ok=90, noalgn=3, lowq=2, badread=1, slow=4,
                 nofp=0, norp=1)
    hist = {151: 40, 200: 50, 0: 7}
    vec, hout = reduce_counters(c, hist)
    assert list(vec) == [101, 90, 3, 2, 1, 4, 0, 1]
    assert hout == hist


def test_initialize_raises_on_bad_coordinator():
    """A host that cannot join its cluster must fail, not run alone and
    write a partial output as if it were the whole (run in a child: a
    failed initialisation may leave jax's distributed state behind)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COORDINATOR_ADDRESS="not-a-host:1")
    r = subprocess.run(
        [sys.executable, "-c",
         "from pandaseq_tpu.parallel.distributed import "
         "maybe_initialize_distributed as m; print(m())"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "Error" in r.stderr
