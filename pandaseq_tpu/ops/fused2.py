"""Fused device step v2: shortlist-only output for a thin wire.

The v1 kernel reconstructed the merged sequence on device and shipped a
[B, O + L2 + 4] int32 plane (~3.6 KB/pair) to the host. The
device->host wire (PCIe) is narrow next to the device, so v2 inverts
the split: the device does only the O(L^2) work — all-overlap integer
counts, k-mer candidate seeding, f32 scoring, winner + top-SL
shortlist — and ships ~80 B/pair.
The host, which already holds the reads it just uploaded, re-derives
the exact f64 winner from the shortlisted integer counts and performs
the O(L) reconstruction/quality/emission in native code
(native/psq_io.cpp:psq_finalize).

Exactness contract (why the shortlist suffices):
  * every count-based algorithm's f32 score is an exact-integer linear
    form evaluated in f32, so |f32 - f64| << BAND for every offset;
  * any offset whose f32 score is within BAND of the f32 maximum is a
    possible f64 winner; any offset outside the band provably loses in
    f64 too;
  * the kernel ships the top-SL offsets by f32 score (ties broken
    toward the smaller offset, matching the reference's ascending
    strict-> loop, assembler.c:131-134) plus ``n_band``, the count of
    offsets inside the band. n_band <= SL ==> the shortlist contains
    the band, hence the exact winner; otherwise (requires > SL
    near-ties) the host replays the pair through the numpy oracle.
  * pear/rdp_mle score per-base f64 LUT sums; their f32 sums carry
    reduction error, so their BAND is wider and the host re-scores
    every shortlisted offset with the exact sequential f64 loop.
  * stitch's wrapped scores (algo_stitch.c:40-56 uint64 quirk) are all
    exactly equal in f64, so when any offset wraps the first wrapped
    offset wins outright and n_band is reported as 1.

Frame layout: inputs arrive REVERSED and left-aligned — frame position
j' of the forward read holds base flen-1-j' (and i of the reverse read
holds base rlen-1-i). The host decoder emits this layout directly,
which removes every per-pair alignment gather from the device graph:
overlap o pairs forward frame row j' with reverse frame row i exactly
on the diagonal o = j' + i + 1 (derivation: the reference pairs
findex = flen+i-o with rindex = rlen-1-i, algo_simple_bayes.c:46-47;
substituting j' = flen-1-findex gives o = j'+i+1), and both k-mer
streams (misc.h:41-43) become uniform window reductions.

The helpers below are composable so the explicitly sharded multi-chip
step (parallel/shard.py) runs the IDENTICAL math with the overlap-plane
rows split across an "op" mesh axis (partial diagonal sums are exact
integers, so a psum reassembles them exactly).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables

KMER_LEN = 8  # misc.h:33

# 2-bit k-mer packing: T=3, G=2, C=1, everything else 0 (misc.h:41)
_KCODE = np.zeros(16, dtype=np.int32)
_KCODE[8], _KCODE[4], _KCODE[2] = 3, 2, 1

# f32-vs-f64 shortlist bands (see module docstring)
BAND_COUNTS = 0.01
BAND_LUT = 0.05
SHORTLIST = 8


def _window9_trail(nonn, L):
    """all-non-N over the trailing window p-8..p (reverse-read emission
    gate: FOREACH_KMER_REVERSE emits once 9 consecutive non-N bases
    have been visited, misc.h:43 + assembler.c:103-109)."""
    cs = jnp.cumsum(nonn.astype(jnp.int32), axis=1)
    cs_pad = jnp.pad(cs, ((0, 0), (9, 0)))[:, :L]  # cs[p-9], 0 for p<9
    return (cs - cs_pad) == 9


def _window9_lead(nonn, L):
    """all-non-N over the leading window p..p+8 (forward-read emission
    gate seen from the reversed frame)."""
    cs = jnp.cumsum(nonn.astype(jnp.int32), axis=1)
    hi = jnp.pad(cs, ((0, 0), (0, 9)))[:, 8:8 + L]  # cs[p+8]
    lo = jnp.pad(cs, ((0, 0), (1, 0)))[:, :L]  # cs[p-1]
    return (hi - lo) == 9


def _kmer_trail(codes, L):
    """k[p] = sum_t codes[p-t] << 2t — the FOREACH_KMER_REVERSE value
    at reversed-frame position p."""
    k = jnp.zeros_like(codes)
    for t in range(KMER_LEN):
        k = k | (jnp.pad(codes, ((0, 0), (t, 0)))[:, :L] << (2 * t))
    return k


def _kmer_lead(codes, L):
    """k[p] = sum_t codes[p+t] << 2t — the FOREACH_KMER value at
    reversed-frame position p."""
    k = jnp.zeros_like(codes)
    for t in range(KMER_LEN):
        k = k | (jnp.pad(codes, ((0, 0), (0, t)))[:, t:t + L] << (2 * t))
    return k


def kmer_frames(nt_f, nt_r, flen, rlen, L, num_kmers):
    """K-mer seeding (assembler.c:91-118, misc.h:32-45) on reversed
    frames. Returns (Fkm, Rkm): per-position k-mer values, -1/-2 where
    not emitted/stored (distinct sentinels so Fkm == Rkm never matches
    on non-emissions)."""
    cf = jnp.asarray(_KCODE)[nt_f]
    cr = jnp.asarray(_KCODE)[nt_r]
    return kmer_frames_codes(cf, nt_f != 0x0F, cr, nt_r != 0x0F,
                             flen, rlen, L, num_kmers)


def _emit_gates(nonn_f, nonn_r, flen, rlen, L):
    """(emit_f, emit_r) k-mer emission masks on reversed frames.
    Forward emits at raw fp >= 8 with fp-8..fp non-N: frame j' has
    window j'..j'+8 and gate j' <= flen-9. Reverse emits at raw pr with
    pr..pr+8 non-N and pr+8 < rlen: frame i has window i-8..i and gates
    i >= 8, i < rlen. Without Ns (nonn None) the windows are implied by
    the positional gates, and skipping them keeps XLA from
    constant-folding a [B, L] cumsum of ones at compile time."""
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    emit_f = pos <= flen[:, None] - 9
    emit_r = (pos >= KMER_LEN) & (pos < rlen[:, None])
    if nonn_f is not None:
        emit_f &= _window9_lead(nonn_f, L)
        emit_r &= _window9_trail(nonn_r, L)
    return emit_f, emit_r


def kmer_frames_codes(cf, nonn_f, cr, nonn_r, flen, rlen, L, num_kmers):
    """kmer_frames on pre-decoded 2-bit k-mer codes (T=3,G=2,C=1,
    else 0, misc.h:41) and non-N masks — the inputs the 4-bit packed
    upload carries directly (the k-mer machinery never needs the full
    4-bit IUPAC code). nonn_f/nonn_r None means no N anywhere."""
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    kf = _kmer_lead(cf, L)
    kr = _kmer_trail(cr, L)
    emit_f, emit_r = _emit_gates(nonn_f, nonn_r, flen, rlen, L)
    if num_kmers == 0:
        # -k 0: empty kmerseen table -> every probe misses ->
        # ALL_BITS_IF_NONE examines every overlap
        stored_f = jnp.zeros_like(emit_f)
    else:
        # kmerseen keeps only the first num_kmers occurrences in RAW
        # order (ascending fp = DESCENDING frame j'): rank = count of
        # same-k-mer emissions at strictly later frame positions.
        # Sort-based segmented rank: key = kmer<<10 | (L-1-j'), so
        # within one kmer's run ascending key order IS raw order, and
        # rank = index - run_start. Two [B, L] sorts replace the old
        # [B, L, L] pairwise plane (whose HBM materialization, not the
        # candidate matmul, dominated the kernel). Both sorts are
        # SINGLE-key: a payload channel adds a second operand to every
        # [B, L] sort, and neither needs one — the first key already
        # contains the position (low 10 bits), and the inverse
        # permutation packs the stored bit into bit 0 of a
        # position-keyed int32. Both sorts are UNSTABLE
        # (is_stable=False): stability is unobservable for a value-only
        # sort, so the cheaper unstable sort gives the same result.
        assert L <= 1024
        big = jnp.int32(1) << 27  # > any (kmer << 10 | pos) key
        key = jnp.where(emit_f, (kf << 10) | (L - 1 - pos), big + pos)
        sk = jax.lax.sort(key, dimension=1, is_stable=False)
        idx = jnp.arange(L, dtype=jnp.int32)[None, :]
        run_start = jnp.concatenate(
            [jnp.ones(sk[:, :1].shape, bool),
             (sk[:, 1:] >> 10) != (sk[:, :-1] >> 10)], axis=1)
        seg_start = jax.lax.cummax(jnp.where(run_start, idx, 0), axis=1)
        stored_sorted = ((idx - seg_start) < num_kmers) & (sk < big)
        # original frame position, recovered from the key itself
        pos_orig = jnp.where(sk < big, (L - 1) - (sk & 1023), sk - big)
        # invert the permutation: each position occurs exactly once, so
        # sorting (pos << 1 | stored) leaves row j at index j, bit 0 =
        # stored flag
        sk2 = jax.lax.sort(
            (pos_orig << 1) | stored_sorted.astype(jnp.int32),
            dimension=1, is_stable=False)
        stored_f = (sk2 & 1) == 1
    Fkm = jnp.where(stored_f, kf, -1)
    Rkm = jnp.where(emit_r, kr, -2)
    return Fkm, Rkm


def _diag_t3(O, j0, Oj, dtype):
    """T3[jl, i, d] = 1 iff (j0 + jl) + i == d — the diagonal-reduction
    indicator for plane rows j0..j0+Oj-1, built from iotas (j0 may be a
    traced per-shard offset)."""
    jl = jnp.arange(Oj, dtype=jnp.int32)[:, None, None]
    i = jnp.arange(O, dtype=jnp.int32)[None, :, None]
    d = jnp.arange(O, dtype=jnp.int32)[None, None, :]
    return ((j0 + jl + i) == d).astype(dtype)


def plane_counts(nt_f, nt_r, Fkm, Rkm, O, j0=0, Oj=None):
    """Exact integer diagonal sums for plane rows j' in [j0, j0+Oj):
    matches m, unknowns unk, k-mer candidate hits candc — each [B, O]
    int32, summed over this row block only. The diagonal reduction is
    ONE int8 dot_general (sums <= 450 so int32 is exact);
    row-partial sums are exact integers, so sharded blocks psum to the
    full-plane result bit-for-bit."""
    B = nt_f.shape[0]
    if Oj is None:
        Oj = O
    sl = lambda x: jax.lax.dynamic_slice_in_dim(x, j0, Oj, axis=1)
    f = sl(nt_f)[:, :, None]
    r = nt_r[:, None, :O]
    f_pad = f == 0
    r_pad = r == 0
    n_mask = ((f == 0x0F) | (r == 0x0F)) & ~f_pad & ~r_pad
    match = ((f & r) != 0) & ~n_mask
    kq = sl(Fkm)[:, :, None] == Rkm[:, None, :O]
    planes = jnp.concatenate(
        [match.astype(jnp.int8), n_mask.astype(jnp.int8),
         kq.astype(jnp.int8)], axis=0)  # [3B, Oj, O]
    T3 = _diag_t3(O, j0, Oj, jnp.int8)
    sums = jax.lax.dot_general(
        planes, T3, (((1, 2), (0, 1)), ((), ())),
        preferred_element_type=jnp.int32)  # [3B, O]
    return sums[:B], sums[B:2 * B], sums[2 * B:]


def lut_plane_sums(fr_q, rr_q, nt_f, nt_r, flen, rlen, L, O, algo_kind,
                   lut_match, lut_mismatch, nn_term, j0=0, Oj=None):
    """f32 per-base LUT score sums for every overlap (pear/rdp_mle),
    over plane rows [j0, j0+Oj): one-hot matmuls against the 47x47
    tables + f32 diagonal reduction. Precision.HIGHEST throughout (full
    f32 on a GPU, never TF32) — a single-pass bf16 or TF32 matmul would
    lose mantissa bits and break the shortlist band."""
    if Oj is None:
        Oj = O
    sl = lambda x: jax.lax.dynamic_slice_in_dim(x, j0, Oj, axis=1)
    qf = sl(fr_q.astype(jnp.int32))  # fwd qual at frame j'
    if algo_kind == "pear":
        # quirk: BOTH quals from the fwd buffer (algo_pear.c:52-54);
        # raw index rlen-1-i reads reversed content below flen, stale
        # persistent-buffer content at/above flen
        x = rlen[:, None] - 1 - jnp.arange(O, dtype=jnp.int32)[None, :]
        idx = jnp.where(x < flen[:, None], flen[:, None] - 1 - x, x)
        q2 = jnp.take_along_axis(
            fr_q.astype(jnp.int32), jnp.clip(idx, 0, L - 1), axis=1)
    else:
        q2 = rr_q.astype(jnp.int32)[:, :O]
    f = sl(nt_f)[:, :, None]
    r = nt_r[:, None, :O]
    f_pad = f == 0
    r_pad = r == 0
    n_mask = ((f == 0x0F) | (r == 0x0F)) & ~f_pad & ~r_pad
    raw_match = (f & r) != 0
    OHf = jax.nn.one_hot(jnp.clip(qf, 0, 46), 47, dtype=jnp.float32)
    OH2 = jax.nn.one_hot(jnp.clip(q2, 0, 46), 47, dtype=jnp.float32)
    Tm = jnp.asarray(lut_match, dtype=jnp.float32)
    Tmm = jnp.asarray(lut_mismatch, dtype=jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    mv = jnp.einsum("bjc,cd,bid->bji", OHf, Tm, OH2, precision=hp)
    mmv = jnp.einsum("bjc,cd,bid->bji", OHf, Tmm, OH2, precision=hp)
    if algo_kind == "pear":
        contrib = jnp.where(n_mask, jnp.float32(nn_term),
                            jnp.where(raw_match, mv, mmv))
    else:
        # rdp_mle has NO N special case (algo_rdp_mle.c:64-71): an N
        # base (0x0F) bit-intersects every code, so N positions score
        # as MATCHES — raw f & r, not the N-excluded match mask
        contrib = jnp.where(raw_match, mv, mmv)
    contrib = jnp.where(f_pad | r_pad, jnp.float32(0), contrib)
    T3f = _diag_t3(O, j0, Oj, jnp.float32)
    return jax.lax.dot_general(
        contrib, T3f, (((1, 2), (0, 1)), ((), ())),
        precision=hp, preferred_element_type=jnp.float32)  # [B, O]


def shortlist_from_counts(m, unk, candc, lutsum, flen, rlen, fo, ro, *,
                          O, SL, minoverlap, maxoverlap, algo_kind,
                          pmatch, pmismatch, nn, band):
    """f32 scoring + candidate-range rules + winner/top-SL packing from
    the (full-plane) integer count sums. Returns [B, 2*SL + 4] int32
    (layout in assemble_shortlist's docstring)."""
    o2 = jnp.arange(1, O + 1, dtype=jnp.int32)[None, :]
    nvalid = jnp.maximum(
        0, jnp.minimum(o2, rlen[:, None])
        - jnp.maximum(0, o2 - flen[:, None]))  # [B, O]
    mm = nvalid - m - unk

    # candidate range (assembler.c:73-84,118). maxoverlap == 0
    # REPLACES the offset-derived bound with min(flen, rlen) — the
    # reference discards it entirely (assembler.c:78-82), so deep
    # primer offsets still score large overlaps (which then fail the
    # post-align len check as NOALGN, assembler.c:145-150)
    maxo = flen + rlen - minoverlap - fo - ro - 1
    if maxoverlap == 0:
        maxo = jnp.minimum(flen, rlen)
    else:
        maxo = jnp.minimum(maxo, maxoverlap)
    in_range = (o2 >= minoverlap) & (o2 <= maxo[:, None])
    cand_in = (candc != 0) & in_range
    none_found = ~jnp.any(cand_in, axis=1)
    cand_in = jnp.where(none_found[:, None], in_range, cand_in)
    examined = jnp.sum(cand_in, axis=1, dtype=jnp.int32)

    # f32 scores: each branch mirrors its f64 formula's edge cases so
    # +/-inf appears on identical offsets on both sides
    wrapped = None
    if algo_kind in ("pear", "rdp_mle"):
        scores = lutsum
    elif algo_kind == "ea_util":
        bad = (mm + unk).astype(jnp.float32)  # algo_ea_util.c:49-55
        scores = jnp.log((bad * bad + 1.0)
                         / jnp.maximum(nvalid, 1).astype(jnp.float32))
    elif algo_kind == "flash":
        ratio = (mm + unk) // jnp.maximum(nvalid, 1)  # int division quirk
        scores = jnp.where(
            nvalid == 0, jnp.float32(-2.0),
            jnp.where(ratio > 0, jnp.log(ratio.astype(jnp.float32)),
                      -jnp.inf))
    elif algo_kind == "stitch":
        # uint64 wrap (algo_stitch.c:40-56): all wrapped scores round to
        # the same f64, so the FIRST wrapped offset wins; +60 (> any
        # log of a <= 1 ratio) reproduces that under first-index ties
        diff = m - mm
        pos_s = jnp.log(jnp.maximum(diff.astype(jnp.float32), 1e-30)
                        / (flen + rlen)[:, None].astype(jnp.float32))
        scores = jnp.where(diff > 0, pos_s,
                           jnp.where(diff < 0, jnp.float32(60.0),
                                     -jnp.inf))
        wrapped = (diff < 0) & cand_in
    else:  # simple_bayesian / uparse shape (algo_simple_bayes.c:45-65)
        tail = (o2 < flen[:, None]) | (o2 < rlen[:, None])
        nn_count = jnp.where(tail,
                             flen[:, None] + rlen[:, None] - 2 * o2 + unk,
                             unk)
        scores = (jnp.float32(nn) * nn_count.astype(jnp.float32)
                  + m.astype(jnp.float32) * jnp.float32(pmatch)
                  + mm.astype(jnp.float32) * jnp.float32(pmismatch))

    scores = jnp.where(cand_in, scores, -jnp.inf)
    besto32 = jnp.argmax(scores, axis=1).astype(jnp.int32) + 1
    best32 = jnp.max(scores, axis=1)

    in_band = (cand_in & jnp.isfinite(scores)
               & (scores >= best32[:, None] - jnp.float32(band)))
    n_band = jnp.sum(in_band, axis=1, dtype=jnp.int32)
    if wrapped is not None:
        n_band = jnp.where(jnp.any(wrapped, axis=1), 1, n_band)

    topv, topi = jax.lax.top_k(scores, SL)  # ties -> lower index
    gat = lambda x: jnp.take_along_axis(x, topi, axis=1)
    live = topv > -jnp.inf
    packed = jnp.where(
        live, (topi + 1) | (gat(m) << 10) | (gat(mm) << 20), 0)
    return jnp.concatenate([
        packed.astype(jnp.int32),
        jax.lax.bitcast_convert_type(
            jnp.where(live, topv, jnp.float32(-3e38)), jnp.int32),
        besto32[:, None],
        examined[:, None],
        n_band[:, None],
        jax.lax.bitcast_convert_type(
            jnp.where(jnp.isfinite(best32), best32, jnp.float32(-3e38)),
            jnp.int32)[:, None],
    ], axis=1)


def _shortlist_core(nt_pack, fr_q, rr_q, flen, rlen, fo, ro, *, L, O,
                    SL, minoverlap, maxoverlap, num_kmers, algo_kind,
                    pmatch, pmismatch, nn, nn_term, band, lut_match,
                    lut_mismatch):
    if O is None:
        O = L
    if band is None:
        band = BAND_LUT if algo_kind in ("pear", "rdp_mle") \
            else BAND_COUNTS
    flen = flen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    fo = fo.astype(jnp.int32)
    ro = ro.astype(jnp.int32)
    nts = nt_pack.astype(jnp.int32) & 0xFF
    nt_f = nts & 0x0F
    nt_r = (nts >> 4) & 0x0F
    Fkm, Rkm = kmer_frames(nt_f, nt_r, flen, rlen, L, num_kmers)
    (nt_f, nt_r, Fkm, Rkm) = jax.lax.optimization_barrier(
        (nt_f, nt_r, Fkm, Rkm))
    m, unk, candc = plane_counts(nt_f, nt_r, Fkm, Rkm, O)
    lutsum = None
    if algo_kind in ("pear", "rdp_mle"):
        lutsum = lut_plane_sums(fr_q.astype(jnp.int32),
                                rr_q.astype(jnp.int32), nt_f, nt_r,
                                flen, rlen, L, O, algo_kind, lut_match,
                                lut_mismatch, nn_term)
    return shortlist_from_counts(
        m, unk, candc, lutsum, flen, rlen, fo, ro, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap,
        algo_kind=algo_kind, pmatch=pmatch, pmismatch=pmismatch, nn=nn,
        band=band)


@functools.partial(
    jax.jit,
    static_argnames=("L", "O", "SL", "minoverlap", "maxoverlap",
                     "num_kmers", "algo_kind", "pmatch", "pmismatch",
                     "nn", "nn_term", "band"))
def assemble_shortlist_packed(plane, flen, rlen, fo, ro, *,
                              L: int, O: int | None = None,
                              SL: int = SHORTLIST, minoverlap: int = 2,
                              maxoverlap: int = 0, num_kmers: int = 2,
                              algo_kind: str = "counts",
                              pmatch: float = 0.0, pmismatch: float = 0.0,
                              nn: float = float(
                                  tables.QUAL_NN_SIMPLE_BAYESIAN),
                              nn_term: float = 0.0,
                              band: float | None = None,
                              lut_match=None, lut_mismatch=None):
    """Single-upload LUT variant: ``plane`` is [B, 3*L] int8 columns
    [nt_pack | fr_q | rr_q]. Each non-tiny jit argument is its own
    host->device transfer, so the three byte planes ship as one
    argument and are sliced apart on device."""
    nt_pack = plane[:, :L]
    fr_q = plane[:, L:2 * L]
    rr_q = plane[:, 2 * L:3 * L]
    return _shortlist_core(
        nt_pack, fr_q, rr_q, flen, rlen, fo, ro, L=L, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap,
        num_kmers=num_kmers, algo_kind=algo_kind, pmatch=pmatch,
        pmismatch=pmismatch, nn=nn, nn_term=nn_term, band=band,
        lut_match=lut_match, lut_mismatch=lut_mismatch)


@functools.partial(
    jax.jit,
    static_argnames=("L", "O", "SL", "minoverlap", "maxoverlap",
                     "num_kmers", "algo_kind", "pmatch", "pmismatch",
                     "nn", "nn_term", "band"))
def assemble_shortlist(nt_pack, fr_q, rr_q, flen, rlen, fo, ro, *,
                       L: int, O: int | None = None, SL: int = SHORTLIST,
                       minoverlap: int = 2, maxoverlap: int = 0,
                       num_kmers: int = 2, algo_kind: str = "counts",
                       pmatch: float = 0.0, pmismatch: float = 0.0,
                       nn: float = float(tables.QUAL_NN_SIMPLE_BAYESIAN),
                       nn_term: float = 0.0, band: float | None = None,
                       lut_match=None, lut_mismatch=None):
    """One dispatch over REVERSED frames -> [B, 2*SL + 4] int32:

      [:SL]        packed shortlist: o | m<<10 | mm<<20 (0 = empty),
                   descending f32 score, ties toward smaller o
      [SL:2*SL]    bitcast f32 scores of those offsets
      [2*SL]       besto32 (f32 argmax offset, first-max)
      [2*SL+1]     examined (number of candidate offsets in range)
      [2*SL+2]     n_band (offsets within ``band`` of the f32 max)
      [2*SL+3]     bitcast f32 best score

    ``nt_pack`` carries BOTH reads' 4-bit codes in one byte plane
    (fwd | rev << 4) — the upload wire is the deployment bottleneck,
    so nt codes ship nibble-packed and unpack on device. Quality
    arrays are consumed only by the pear/rdp_mle LUT scoring; the
    count-based algorithms use assemble_shortlist_nt, which uploads
    only the nt plane (256 B/pair at L=256).
    """
    return _shortlist_core(
        nt_pack, fr_q, rr_q, flen, rlen, fo, ro, L=L, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap,
        num_kmers=num_kmers, algo_kind=algo_kind, pmatch=pmatch,
        pmismatch=pmismatch, nn=nn, nn_term=nn_term, band=band,
        lut_match=lut_match, lut_mismatch=lut_mismatch)


@functools.partial(
    jax.jit,
    static_argnames=("L", "O", "SL", "minoverlap", "maxoverlap",
                     "num_kmers", "algo_kind", "pmatch", "pmismatch",
                     "nn", "band"))
def assemble_shortlist_nt(nt_pack, flen, rlen, fo, ro, *, L: int,
                          O: int | None = None, SL: int = SHORTLIST,
                          minoverlap: int = 2, maxoverlap: int = 0,
                          num_kmers: int = 2, algo_kind: str = "counts",
                          pmatch: float = 0.0, pmismatch: float = 0.0,
                          nn: float = float(
                              tables.QUAL_NN_SIMPLE_BAYESIAN),
                          band: float | None = None):
    """Quals-free variant of assemble_shortlist for the count-based
    algorithms (simple_bayesian/uparse/ea_util/flash/stitch): their
    scores depend only on integer counts, and reconstruction happens on
    host, so the device upload is just the nibble-packed nt plane."""
    assert algo_kind not in ("pear", "rdp_mle")
    return _shortlist_core(
        nt_pack, None, None, flen, rlen, fo, ro, L=L, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap,
        num_kmers=num_kmers, algo_kind=algo_kind, pmatch=pmatch,
        pmismatch=pmismatch, nn=nn, nn_term=0.0, band=band,
        lut_match=None, lut_mismatch=None)


def cand_mask_join(cf, nonn_f, cr, nonn_r, flen, rlen, L, O, num_kmers):
    """Candidate bitmask via a sorted k-mer JOIN — O(L log L) per pair
    instead of the O(L * O^2) diagonal-reduction matmul, built ONLY
    from one sort, reverse cumulative mins and elementwise ops (no
    per-row gathers).

    Key identity: under the key (kmer << 10 | (L-1-j')), ascending
    order within one k-mer's run IS raw ascending order, so the first
    num_kmers keys of a run are exactly the kmerseen-stored positions
    (assembler.c:91-100). Sort the forward emissions TOGETHER with the
    reverse-emission probe keys (kmer << 10, tie-broken before equal
    sources); then for every probe lane the t-th smallest source key
    >= it — the t-th stored occurrence of its k-mer, if the k-mer
    matches — arrives by pure propagation:

        m_0 = source ? key : INF          r_0 = rcummin(m_0)
        m_t = source ? r_{t-1}[i+1] : INF r_t = rcummin(m_t)

    (r_{t-1}[i+1] at a source lane is that source's t-th successor key;
    all chains are ascending, so rcummin propagates the nearest one.)
    Each (stored j', probe i) k-mer match contributes candidate offset
    o = j' + i + 1; bits OR-reduce into [B, O//32] words (idempotent —
    no dedupe pass needed).

    Exactly equal to (plane_cand != 0 | pack_bits16) for num_kmers <=
    the propagation unroll; only k in {1, 2} reaches the device (k >= 3
    is host-faithful, k = 0 stores nothing). Tested against the matmul
    twin, which remains the op-sharded mesh path."""
    B = cf.shape[0]
    W = O // 32
    if num_kmers <= 0:  # nothing stored -> empty mask
        return jnp.zeros((B, W), dtype=jnp.int32)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    kf = _kmer_lead(cf, L)
    kr = _kmer_trail(cr, L)
    emit_f, emit_r = _emit_gates(nonn_f, nonn_r, flen, rlen, L)
    assert L <= 1024
    # ONE int32 key carries everything — kmer<<11 | src<<10 | pos10 —
    # so the combined sort needs no payload operand. Real kmers are
    # 16-bit; non-emitted lanes park above 2^29, distinct per lane.
    src_v = jnp.where(emit_f, (kf << 11) | 1024 | (L - 1 - pos),
                      jnp.int32(0x20000000) | 1024 | pos)
    prb_v = jnp.where(emit_r, (kr << 11) | pos,
                      jnp.int32(0x28000000) | pos)
    v = jax.lax.sort(jnp.concatenate([src_v, prb_v], axis=1),
                     dimension=1, is_stable=False)
    is_src = (v & 1024) != 0
    INF = jnp.int32(0x7FFFFFFF)
    inf_col = jnp.full((B, 1), INF, jnp.int32)
    kmer_lane = v >> 11
    i_lane = v & 1023  # probe's reverse position at probe lanes
    r_prev = None
    cand = []
    for _ in range(num_kmers):
        # m at source lanes: own key (t=0) or the t-th successor's key
        # (t>0, via the previous round's propagation shifted one lane);
        # both chains ascend, so reverse cummin propagates the nearest
        m = jnp.where(is_src,
                      v if r_prev is None
                      else jnp.concatenate([r_prev[:, 1:], inf_col],
                                           axis=1),
                      INF)
        r = jax.lax.cummin(m, axis=1, reverse=True)
        ok = ~is_src & ((r >> 11) == kmer_lane)
        o = (L - 1 - (r & 1023)) + i_lane + 1
        ok &= (o >= 1) & (o <= O)
        cand.append(jnp.where(ok, o - 1, jnp.int32(-1)))
        r_prev = r
    # pack: dedupe by one more 1-key sort, then per-word
    # sum-of-distinct-powers == OR. The W loop is unrolled python-side
    # so every op stays full-width [B, P]
    so = jax.lax.sort(jnp.concatenate(cand, axis=1), dimension=1,
                      is_stable=False)
    uniq = (so >= 0) & jnp.concatenate(
        [jnp.ones((B, 1), bool), so[:, 1:] != so[:, :-1]], axis=1)
    word = so >> 5
    bit = jnp.where(uniq, jnp.int32(1) << (so & 31), jnp.int32(0))
    cols = [jnp.sum(jnp.where(word == w, bit, 0), axis=1,
                    dtype=jnp.int32) for w in range(W)]
    return jnp.stack(cols, axis=1)


def plane_cand(Fkm, Rkm, O, j0=0, Oj=None):
    """K-mer candidate plane only: candc[b, o-1] = # of (j', i) pairs
    with equal stored/emitted k-mers on diagonal o = j'+i+1 — the
    device work for the sparse LUT path, which needs neither the match
    nor the N planes (selection math runs on host)."""
    if Oj is None:
        Oj = O
    if isinstance(j0, int) and j0 == 0 and Oj == O:
        # static full-plane case (the single-chip production path;
        # the op-sharded mesh passes a traced per-shard j0)
        return _plane_cand_tri(Fkm, Rkm, O)
    sl = lambda x: jax.lax.dynamic_slice_in_dim(x, j0, Oj, axis=1)
    kq = (sl(Fkm)[:, :, None] == Rkm[:, None, :O]).astype(jnp.int8)
    T3 = _diag_t3(O, j0, Oj, jnp.int8)
    return jax.lax.dot_general(
        kq, T3, (((1, 2), (0, 1)), ((), ())),
        preferred_element_type=jnp.int32)  # [B, O]


def _plane_cand_tri(Fkm, Rkm, O, nb=8):
    """plane_cand for the static j0=0, Oj=O case, blocked along the
    stored-frame axis j into ``nb`` chunks so each dot only spans the
    LIVE part of the triangle: diagonals t = j + i stop mattering at
    t >= O (overlap o = t+1 <= O, assembler.c:84-118), so chunk c
    (j in [c*w, (c+1)*w)) needs only i < O - c*w and writes only the
    band t in [c*w, O). MACs drop to sum_c w*(O-c*w)^2 and the
    materialized kq equality plane (XLA writes it to device memory
    before each GEMM) shrinks to (nb+1)/(2*nb) of [B, O, O] int8.
    nb=8: on an H100 at B=16384, L=O=256 the int8 plane took a median
    1.71 ms at nb=8, 1.78 at nb=16, 2.02 at nb=4 and 3.24 at nb=1
    (PERF.md, "H100 bring-up"). Exactly equal to the dense product:
    every dropped MAC is provably zero."""
    if O % nb:
        nb = 2 if O % 2 == 0 else 1
    B = Fkm.shape[0]
    w = O // nb
    acc = jnp.zeros((B, O), jnp.int32)
    for c in range(nb):
        jc = c * w
        iw = O - jc
        kq = (Fkm[:, jc:jc + w, None] == Rkm[:, None, :iw]).astype(
            jnp.int8)
        # T3c[jl, i, d'] = 1 iff jl + i == d', band output width iw,
        # global diagonal d = jc + d'
        jl = jnp.arange(w, dtype=jnp.int32)[:, None, None]
        i = jnp.arange(iw, dtype=jnp.int32)[None, :, None]
        d = jnp.arange(iw, dtype=jnp.int32)[None, None, :]
        T3c = ((jl + i) == d).astype(jnp.int8)
        part = jax.lax.dot_general(
            kq, T3c, (((1, 2), (0, 1)), ((), ())),
            preferred_element_type=jnp.int32)  # [B, iw]
        acc = acc + jnp.pad(part, ((0, 0), (jc, 0)))
    return acc


def pack_bits16(nz, O):
    """[B, O] 0/1 int32 -> [B, O//32] int32 words, bit (o-1)%32 of word
    (o-1)//32 for offset o = index+1 (32 bits per word halves the
    device->host wire vs 16). A tiny dot_general; each weight
    contributes to one output word at most once, so the wrapping int32
    accumulation of 1<<31 is still the exact bit pattern (sum of
    distinct powers == OR)."""
    idx = np.arange(O, dtype=np.int64)
    W32 = ((idx[:, None] // 32 == np.arange(O // 32)[None, :])
           * (1 << (idx % 32))[:, None]) & 0xFFFFFFFF
    W32 = W32.astype(np.uint32).view(np.int32)
    return jax.lax.dot_general(
        nz.astype(jnp.int32), jnp.asarray(W32),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)


@functools.partial(jax.jit, static_argnames=("L", "O", "num_kmers"))
def assemble_candidates_nt(nt_pack, flen, rlen, *, L: int,
                           O: int | None = None, num_kmers: int = 2):
    """Sparse LUT-algorithm device step: k-mer seeding only.

    pear/rdp_mle score per-base f64 LUT sums; on host those sums cost
    O(overlap) per *candidate* offset, and k-mer seeding leaves ~1-8
    candidates per pair on real data — so the device's only job is the
    O(L^2) candidate search (assembler.c:84-118). Output is the
    candidate bitmask, [B, O//32] int32 words (32 B/pair at
    O=256); the host applies the range rules, the ALL_BITS_IF_NONE
    fallback (assembler.c:42,118) and the exact sequential f64 scoring
    loop (native/psq_io.cpp:psq_finalize, plane_kind=1). No quality
    upload, no f32 LUT planes, no shortlist band: the f64 selection is
    exact by construction."""
    if O is None:
        O = L
    flen = flen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    nts = nt_pack.astype(jnp.int32) & 0xFF
    nt_f = nts & 0x0F
    nt_r = (nts >> 4) & 0x0F
    Fkm, Rkm = kmer_frames(nt_f, nt_r, flen, rlen, L, num_kmers)
    (Fkm, Rkm) = jax.lax.optimization_barrier((Fkm, Rkm))
    candc = plane_cand(Fkm, Rkm, O)
    return pack_bits16(candc != 0, O)


# first-C candidate offsets shipped; count > C rows recompute on host.
# C=4: [B, 6] int16 = 12 B/pair, covers 99.67% of 2x250 MiSeq-like rows
# (mean distinct candidates 1.33); the host twin absorbs the rest at
# ~5.5 ms/batch even if EVERY row overflowed, so there is no cliff
CAND_LIST_C = 4


@functools.partial(jax.jit, static_argnames=("L", "O", "num_kmers", "C"))
def assemble_candidates_list_packed4(plane4, flen, rlen, *, L: int,
                                     O: int | None = None,
                                     num_kmers: int = 2,
                                     C: int = CAND_LIST_C):
    """assemble_candidates_packed4 shipping a candidate LIST instead of
    the bitmask: [B, C+2] int16 rows = [count, first C offsets
    ascending (0-padded), 0]. 12 B/pair at C=4 vs the mask's 32 B at
    O=256 — the device->host wire is half-duplex with the upload, so
    halving the download buys real headline throughput. Rows with
    count > C (0.33% on MiSeq-like data: mean distinct candidates is
    ~1.3 at k=2, 16-bit k-mer collisions add ~1) are recomputed exactly
    on host via psq_cand_mask — the same fixup channel hasN rows
    already ride, so the engine's exactness contract is unchanged."""
    if O is None:
        O = L
    assert O <= 1024  # offsets must fit int16; overflow O routes host
    candc = _candc_packed4(plane4, flen, rlen, L, O, num_kmers)
    present = candc != 0
    cnt = jnp.sum(present, axis=1, dtype=jnp.int32)
    big = jnp.int32(1) << 20
    offs = jnp.where(present,
                     jnp.arange(1, O + 1, dtype=jnp.int32)[None, :], big)
    so = jax.lax.sort(offs, dimension=1, is_stable=False)[:, :C]
    so = jnp.where(so >= big, 0, so)
    B = candc.shape[0]
    out = jnp.concatenate(
        [cnt[:, None], so, jnp.zeros((B, 1), jnp.int32)], axis=1)
    return out.astype(jnp.int16)


def _unpack2bit(plane4, L):
    """(cf, cr, None): 2-bit k-mer codes from the 4-bit packed upload
    plane (psq_pack4 layout), which carries no N positions."""
    assert L % 8 == 0, L
    q = L // 4
    p32 = plane4.astype(jnp.int32) & 0xFF
    unpack2 = lambda w: jnp.concatenate(
        [(w >> (2 * t)) & 3 for t in range(4)], axis=1)  # [B, L]
    cf = unpack2(p32[:, :q])
    cr = unpack2(p32[:, q:2 * q])
    return cf, cr, None


def _candc_packed4(plane4, flen, rlen, L, O, num_kmers):
    """Shared candidate-count plane from the 4-bit packed upload —
    the single implementation both the mask and list kernels wrap."""
    flen = flen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    cf, cr, nonn = _unpack2bit(plane4, L)
    Fkm, Rkm = kmer_frames_codes(cf, nonn, cr, nonn, flen, rlen,
                                 L, num_kmers)
    (Fkm, Rkm) = jax.lax.optimization_barrier((Fkm, Rkm))
    return plane_cand(Fkm, Rkm, O)


@functools.partial(jax.jit, static_argnames=("L", "O", "num_kmers"))
def assemble_candidates_packed4(plane4, flen, rlen, *, L: int,
                                O: int | None = None, num_kmers: int = 2):
    """assemble_candidates_packed without the N planes: [fwd2 | rev2]
    only, 4 bits/position (128 B/pair at Lb=256). The device treats
    every position as non-N; the host recomputes the (rare) rows that
    do contain N exactly with psq_cand_mask before finalization, so
    the upload sheds a third of its bytes without changing any
    result."""
    if O is None:
        O = L
    if num_kmers <= 2 and os.environ.get("PANDASEQ_TPU_JOIN"):
        # alternate sorted-join kernel (opt-in): O(L log L)/pair vs the
        # matmul's O(L*O^2); exactness-tested against the matmul, which
        # stays the default (PERF.md has both times on the card)
        cf, cr, nonn = _unpack2bit(plane4, L)
        return cand_mask_join(cf, nonn, cr, nonn,
                              flen.astype(jnp.int32),
                              rlen.astype(jnp.int32), L, O, num_kmers)
    candc = _candc_packed4(plane4, flen, rlen, L, O, num_kmers)
    return pack_bits16(candc != 0, O)


def build_ptable(algo) -> np.ndarray:
    """Host-side f64 table PTBL[case*2209 + fq*47 + rq] of exact
    per-base log-probabilities for one algorithm (case codes from the
    reconstruction, assembler.c:162-243: 0 hole, 1 fwd copy, 2 rev
    copy, 3 overlap match, 4 overlap mismatch, 5 both B-cliff masked,
    6 fwd masked, 7 rev masked)."""
    from ..assembler import _match_probability_vec

    fqg, rqg = np.meshgrid(np.arange(47), np.arange(47), indexing="ij")
    fqf = fqg.ravel()
    rqf = rqg.ravel()
    tbl = np.zeros(8 * 2209, dtype=np.float64)
    qs = tables.QUAL_SCORE
    nn = float(tables.QUAL_NN_SIMPLE_BAYESIAN)
    try:
        mp_match = _match_probability_vec(algo, np.ones(2209, bool),
                                          fqf, rqf)
        mp_mis = _match_probability_vec(algo, np.zeros(2209, bool),
                                        fqf, rqf)
    except ValueError:  # custom algorithm: scalar match_probability
        mp_match = np.array([algo.match_probability(True, a, b)
                             for a, b in zip(fqf, rqf)])
        mp_mis = np.array([algo.match_probability(False, a, b)
                           for a, b in zip(fqf, rqf)])
    for case in range(8):
        base = case * 2209
        if case == 1 or case == 7:
            tbl[base:base + 2209] = qs[fqf]
        elif case == 2 or case == 6:
            tbl[base:base + 2209] = qs[rqf]
        elif case == 3:
            tbl[base:base + 2209] = mp_match
        elif case == 4:
            tbl[base:base + 2209] = mp_mis
        elif case == 5:
            tbl[base:base + 2209] = nn
    return tbl
