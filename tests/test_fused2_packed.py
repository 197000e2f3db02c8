"""The single-upload concatenated plane must be a pure re-encoding:
assemble_shortlist_packed (one [B, 3L] int8 argument) equals the
three-argument assemble_shortlist bit-for-bit."""

import numpy as np
import pytest


def _popcount_rows(mask):
    """Per-row set-bit count (numpy<2 lacks np.bitwise_count)."""
    return np.unpackbits(mask.view(np.uint8), axis=1).sum(axis=1)


from pandaseq_tpu.ops import fused2
from pandaseq_tpu import tables


def _rand_batch(rng, B, L):
    nt_pack = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    # zero tails like the decoder does (left-aligned reversed frames)
    flen = rng.integers(30, L, size=B).astype(np.int32)
    rlen = rng.integers(30, L, size=B).astype(np.int32)
    for b in range(B):
        nt_pack[b, max(flen[b], rlen[b]):] = 0
    fr_q = rng.integers(0, 47, size=(B, L)).astype(np.int8)
    rr_q = rng.integers(0, 47, size=(B, L)).astype(np.int8)
    fo = np.zeros(B, np.int32)
    ro = np.zeros(B, np.int32)
    return nt_pack.view(np.int8), fr_q, rr_q, flen, rlen, fo, ro


def test_packed_lut_matches_unpacked():
    rng = np.random.default_rng(2)
    B, L = 16, 64
    nt_pack, fr_q, rr_q, flen, rlen, fo, ro = _rand_batch(rng, B, L)
    lut_m = np.log(np.clip(rng.random((47, 47)), 1e-3, 1)).astype(
        np.float64)
    lut_mm = np.log(np.clip(rng.random((47, 47)), 1e-3, 1)).astype(
        np.float64)
    kw = dict(L=L, O=L, algo_kind="rdp_mle", pmatch=0.0, pmismatch=0.0,
              nn_term=float(tables.QUAL_NN_SIMPLE_BAYESIAN),
              lut_match=lut_m, lut_mismatch=lut_mm)
    ref = np.asarray(fused2.assemble_shortlist(
        nt_pack, fr_q, rr_q, flen, rlen, fo, ro, **kw))
    plane = np.concatenate([nt_pack, fr_q, rr_q], axis=1)
    got = np.asarray(fused2.assemble_shortlist_packed(
        plane, flen, rlen, fo, ro, **kw))
    np.testing.assert_array_equal(got, ref)


def test_packed_pear_matches_unpacked():
    rng = np.random.default_rng(3)
    B, L = 12, 64
    nt_pack, fr_q, rr_q, flen, rlen, fo, ro = _rand_batch(rng, B, L)
    lut_m = np.log(np.clip(rng.random((47, 47)), 1e-3, 1)).astype(
        np.float64)
    lut_mm = np.log(np.clip(rng.random((47, 47)), 1e-3, 1)).astype(
        np.float64)
    kw = dict(L=L, O=L, algo_kind="pear", pmatch=0.0, pmismatch=0.0,
              nn_term=-1.25, lut_match=lut_m, lut_mismatch=lut_mm)
    ref = np.asarray(fused2.assemble_shortlist(
        nt_pack, fr_q, rr_q, flen, rlen, fo, ro, **kw))
    plane = np.concatenate([nt_pack, fr_q, rr_q], axis=1)
    got = np.asarray(fused2.assemble_shortlist_packed(
        plane, flen, rlen, fo, ro, **kw))
    np.testing.assert_array_equal(got, ref)


def test_candidates_pack4_with_host_n_fix_matches_nt():
    """The 4-bit upload (no N planes) + the native host mask for
    N-containing rows must reproduce the full nibble-plane device
    result (assemble_candidates_nt, which sees the true N positions)
    exactly, on data dense with N runs and degenerate codes."""
    from pandaseq_tpu.io import native

    if native.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(13)
    B, L = 32, 128
    codes = np.array([1, 2, 4, 8, 15, 15, 15, 5, 10], dtype=np.uint8)
    fwd = codes[rng.integers(0, len(codes), size=(B, L))]
    rev = codes[rng.integers(0, len(codes), size=(B, L))]
    # a few rows entirely N-free so both device paths agree on them
    fwd[:4] = np.array([1, 2, 4, 8], np.uint8)[
        rng.integers(0, 4, size=(4, L))]
    rev[:4] = np.array([1, 2, 4, 8], np.uint8)[
        rng.integers(0, 4, size=(4, L))]
    flen = rng.integers(20, L, size=B).astype(np.int32)
    rlen = rng.integers(20, L, size=B).astype(np.int32)
    pos = np.arange(L)[None, :]
    fwd[pos >= flen[:, None]] = 0
    rev[pos >= rlen[:, None]] = 0
    nt_pack = (fwd | (rev << 4)).view(np.int8)

    class _B:
        sids = list(range(B))
        fwd_nt = fwd.view(np.int8)
        rev_nt = rev.view(np.int8)

        def nt_packed(self):
            return nt_pack

    _B.flen = flen
    _B.rlen = rlen

    ref = np.asarray(fused2.assemble_candidates_nt(
        nt_pack, flen, rlen, L=L))

    plane4, hasN = native.pack4(_B(), L)
    assert plane4.shape == (B, 2 * L // 4)
    expect_hasN = ((fwd == 15) | (rev == 15)).any(axis=1)
    np.testing.assert_array_equal(hasN, expect_hasN)
    got = np.array(np.asarray(fused2.assemble_candidates_packed4(
        plane4, flen, rlen, L=L)))
    rows = np.flatnonzero(hasN)
    got[rows] = native.cand_mask(_B(), rows, 2, L)
    np.testing.assert_array_equal(got, ref)

    # num_kmers=1 and 3 paths through the host twin as well
    for nk in (1, 3):
        ref_k = np.asarray(fused2.assemble_candidates_nt(
            nt_pack, flen, rlen, L=L, num_kmers=nk))
        got_k = np.array(np.asarray(fused2.assemble_candidates_packed4(
            plane4, flen, rlen, L=L, num_kmers=nk)))
        got_k[rows] = native.cand_mask(_B(), rows, nk, L)
        np.testing.assert_array_equal(got_k, ref_k)


def test_cand_mask_join_matches_matmul_twin():
    """The gather-free sorted-join kernel (fused2.cand_mask_join,
    opt-in via PANDASEQ_TPU_JOIN) must equal the production diagonal
    matmul bit-for-bit, including deep k-mer runs (low-entropy rows,
    rank >= num_kmers drops), edge lengths, and k in {0, 1, 2}."""
    import jax.numpy as jnp

    from pandaseq_tpu.ops import fused2

    rng = np.random.default_rng(7)
    cases = [(2, 128, 2), (2, 256, 4), (1, 256, 4), (0, 256, 2),
             (2, 384, 2), (1, 128, 2)]
    for nk, L, alpha in cases:
        B, O = 64, L
        cf = rng.integers(0, alpha, size=(B, L)).astype(np.int32)
        cr = rng.integers(0, alpha, size=(B, L)).astype(np.int32)
        flen = rng.integers(2, L + 1, size=B).astype(np.int32)
        rlen = rng.integers(2, L + 1, size=B).astype(np.int32)
        flen[:4] = [2, 9, 10, L]
        rlen[:4] = [2, 9, L, 10]
        pos = np.arange(L)[None, :]
        cf = np.where(pos < flen[:, None], cf, 0)
        cr = np.where(pos < rlen[:, None], cr, 0)
        nonn = jnp.ones((B, L), bool)
        Fkm, Rkm = fused2.kmer_frames_codes(
            jnp.asarray(cf), nonn, jnp.asarray(cr), nonn, flen, rlen,
            L, nk)
        ref = np.asarray(fused2.pack_bits16(
            fused2.plane_cand(Fkm, Rkm, O) != 0, O))
        got = np.asarray(fused2.cand_mask_join(
            jnp.asarray(cf), nonn, jnp.asarray(cr), nonn, flen, rlen,
            L, O, nk))
        np.testing.assert_array_equal(got, ref, err_msg=f"nk={nk} L={L}")


def test_cand_list_matches_mask_including_overflow():
    """The candidate-list download ([count, first C offsets]) must
    agree with the bitmask kernel, including rows whose count exceeds
    C (low-entropy reads: every k-mer equal -> candidates on many
    diagonals), which the engine recomputes host-side."""
    from pandaseq_tpu.ops import fused2

    C = fused2.CAND_LIST_C
    L = O = 128
    B = 32
    rng = np.random.default_rng(5)
    # half the rows poly-'C' (2-bit code 1 everywhere): every forward
    # k-mer equals every reverse k-mer -> dozens of candidate diagonals
    plane4 = rng.integers(-128, 128, size=(B, 2 * L // 4), dtype=np.int8)
    plane4[:B // 2] = 0b01010101
    flen = np.full(B, 120, np.int32)
    rlen = np.full(B, 120, np.int32)
    mask = np.asarray(fused2.assemble_candidates_packed4(
        plane4, flen, rlen, L=L, O=O, num_kmers=2))
    lst = np.asarray(fused2.assemble_candidates_list_packed4(
        plane4, flen, rlen, L=L, O=O, num_kmers=2))
    cnt_true = _popcount_rows(mask)
    assert (cnt_true[:B // 2] > C).all()  # overflow regime exercised
    np.testing.assert_array_equal(lst[:, 0].astype(np.int64), cnt_true)
    for b in range(B):
        bits = np.flatnonzero(np.unpackbits(
            mask[b].view(np.uint8), bitorder="little")) + 1
        want = list(bits[:C]) + [0] * (C - min(C, len(bits)))
        assert list(lst[b, 1:1 + C]) == want, b


def _dense_plane_cand(F, R, O):
    """The untiled diagonal reduction: the reference every blocking of
    fused2._plane_cand_tri must equal."""
    import jax
    import jax.numpy as jnp

    kq = (F[:, :O, None] == R[:, None, :O]).astype(jnp.int8)
    T3 = fused2._diag_t3(O, 0, O, jnp.int8)
    return jax.lax.dot_general(
        kq, T3, (((1, 2), (0, 1)), ((), ())),
        preferred_element_type=jnp.int32)


@pytest.mark.parametrize("B,L,O", [(4, 256, 256), (8, 128, 96),
                                   (4, 384, 384)])
def test_tri_equals_dense_various_nb(B, L, O):
    """Triangular blocking drops only provably-zero MACs: every nb
    that divides O equals the dense product bit-for-bit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    Fkm = rng.integers(0, 300, (B, L)).astype(np.int32)
    Rkm = rng.integers(0, 300, (B, L)).astype(np.int32)
    Fkm[rng.random((B, L)) < 0.3] = -1   # not stored
    Rkm[rng.random((B, L)) < 0.3] = -2   # not emitted
    F, R = jnp.asarray(Fkm), jnp.asarray(Rkm)
    ref = np.asarray(_dense_plane_cand(F, R, O))
    for nb in (1, 2, 4, 8, 16):
        if O % nb:
            continue
        got = np.asarray(fused2._plane_cand_tri(F, R, O, nb=nb))
        assert np.array_equal(ref, got), (B, L, O, nb)
