"""Decode-skip for unclaimed mux batches (psq_skip_batch /
_claimed_batches): a host sharing one stream must see bit-identical
planes for its claimed batches whether the other hosts' batches were
fully decoded or skipped — including the persistent-quality-buffer
stale tails (fastq.c:33-36 PEAR quirk), NODATA counting, error
position and stream flags (mux.c:132-161)."""

import numpy as np
import pytest

from pandaseq_tpu.io import native

if native.get_lib() is None:  # pragma: no cover
    pytest.skip("native decoder unavailable", allow_module_level=True)

B = 16  # tiny batches so several fit in a small file


def _fastq(path, n, seed, direction, lengths=None, nodata=()):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n):
            ln = 0 if i in nodata else (
                int(lengths[i % len(lengths)]) if lengths else 60)
            seq = "".join(rng.choice(list("ACGT"), size=ln))
            q = "".join(chr(33 + int(c))
                        for c in rng.integers(2, 40, size=ln))
            fh.write("@M00:1:FC:1:1:%d:%d %s:N:0:ACGT\n%s\n+\n%s\n"
                     % (1000 + i, 2000 + i, direction, seq, q))


def _mk_pair(tmp_path, n=64, lengths=(60, 41, 55, 33), nodata=()):
    f1 = str(tmp_path / "s1.fastq")
    f2 = str(tmp_path / "s2.fastq")
    _fastq(f1, n, 1, "1", lengths, nodata)
    _fastq(f2, n, 2, "2", lengths, nodata)
    return f1, f2


def _decode_all(f1, f2):
    return list(native.NativeBatchReader(f1, f2, batch=B, L=512))


def _equal_batch(a, b):
    assert list(a.sids) == list(b.sids)
    for fld in ("fwd_nt", "fwd_q", "rev_nt", "rev_q", "flen", "rlen"):
        np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                      err_msg=fld)


def test_skip_then_decode_bit_identical(tmp_path):
    """Varying read lengths make the qual tails carry PREVIOUS records'
    bytes — skipping batch k must leave batch k+1 byte-identical."""
    f1, f2 = _mk_pair(tmp_path)
    full = _decode_all(f1, f2)
    assert len(full) == 4
    rdr = native.NativeBatchReader(f1, f2, batch=B, L=512)
    assert rdr.skip_batch() == B
    _equal_batch(next(rdr), full[1])
    assert rdr.skip_batch() == B
    _equal_batch(next(rdr), full[3])


def test_skip_counts_nodata_like_decode(tmp_path):
    """Zero-length records are consumed but not emitted (fastq.c:191):
    skip must agree with decode on where every batch boundary falls."""
    f1, f2 = _mk_pair(tmp_path, n=70, nodata=(3, 17, 40))
    full = _decode_all(f1, f2)
    rdr = native.NativeBatchReader(f1, f2, batch=B, L=512)
    ns = []
    while True:
        n = rdr.skip_batch()
        if n == 0:
            break
        ns.append(n)
    assert ns == [len(b.sids) for b in full]

    # and a mixed skip/decode walk lands on the same batches
    rdr = native.NativeBatchReader(f1, f2, batch=B, L=512)
    assert rdr.skip_batch() == len(full[0].sids)
    _equal_batch(next(rdr), full[1])
    assert rdr.skip_batch() == len(full[2].sids)
    _equal_batch(next(rdr), full[3])


def test_skip_error_position_and_flags(tmp_path):
    f1, f2 = _mk_pair(tmp_path, n=40)
    # corrupt a record in the 2nd batch: invalid nt char ('Z'; note
    # '!' would alias to 'A' under the reference's &0x1F table index)
    lines = open(f1).readlines()
    lines[4 * 20 + 1] = lines[4 * 20 + 1][:5] + "Z" \
        + lines[4 * 20 + 1][6:]
    open(f1, "w").writelines(lines)
    ref = native.NativeBatchReader(f1, f2, batch=B, L=512)
    full = list(ref)
    rdr = native.NativeBatchReader(f1, f2, batch=B, L=512)
    ns = []
    while True:
        n = rdr.skip_batch()
        if n == 0:
            break
        ns.append(n)
    assert ns == [len(b.sids) for b in full]
    assert rdr.error == ref.error == "BADNT"
    assert rdr.non_empty == ref.non_empty


def test_claimed_batches_partition_and_match(tmp_path):
    from pandaseq_tpu.parallel.distributed import _claimed_batches
    f1, f2 = _mk_pair(tmp_path, n=100)
    full = _decode_all(f1, f2)
    seen = {}
    for claim in (0, 1, 2):
        for i, b in _claimed_batches(f1, f2, B, 512, claim, 3, -1):
            assert i % 3 == claim
            assert i not in seen
            seen[i] = True
            _equal_batch(b, full[i])
    assert sorted(seen) == list(range(len(full)))


def test_skip_gzip_stream(tmp_path):
    """Skip works over compressed streams (the Stream layer handles
    gz/bz2 below the line scanner, fileio.c:60-98)."""
    import gzip
    import shutil
    f1, f2 = _mk_pair(tmp_path, n=48)
    g1 = str(tmp_path / "s1.fastq.gz")
    with open(f1, "rb") as src, gzip.open(g1, "wb") as dst:
        shutil.copyfileobj(src, dst)
    full = _decode_all(f1, f2)
    rdr = native.NativeBatchReader(g1, f2, batch=B, L=512)
    assert rdr.skip_batch() == B
    _equal_batch(next(rdr), full[1])


def test_skip_with_index_reads(tmp_path):
    """Index (barcode) streams advance in lock-step during skip — the
    tag parse and NOTPAIRED checks fire identically (fastq.c:159-188)."""
    f1, f2 = _mk_pair(tmp_path, n=48)
    fi = str(tmp_path / "si.fastq")
    _fastq(fi, 48, 3, "1", lengths=(6,))
    full = list(native.NativeBatchReader(f1, f2, batch=B, L=512,
                                         index_path=fi))
    rdr = native.NativeBatchReader(f1, f2, batch=B, L=512,
                                   index_path=fi)
    assert rdr.skip_batch() == B
    gb = next(rdr)
    _equal_batch(gb, full[1])  # sids carry the injected barcode tags
    # independent check: every id's tag suffix is the barcode ACGT-ish
    # text, not the stream's tag-policy placeholder
    tags = {str(s).rsplit(":", 1)[1] for s in gb.sids}
    assert all(set(t) <= set("ACGTN") and len(t) == 6 for t in tags)


def test_claimed_batches_resume_watermark(tmp_path):
    from pandaseq_tpu.parallel.distributed import _claimed_batches
    f1, f2 = _mk_pair(tmp_path, n=100)
    full = _decode_all(f1, f2)
    got = list(_claimed_batches(f1, f2, B, 512, 0, 2, 2))
    idx = [i for i, _ in got]
    assert idx == [i for i in range(len(full))
                   if i % 2 == 0 and i > 2]
    for i, b in got:
        _equal_batch(b, full[i])
