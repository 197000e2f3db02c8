"""Multi-chip execution: device meshes, the sharded production step,
collective STAT counters.

The reference's only parallelism is single-node pthread data-parallelism
over read pairs (pool.c:110, mux.c:132) — read pairs are independent, so
the design here is a 1-D (or 2-D) SPMD program over a
jax.sharding.Mesh:

  * ``dp`` axis: the batch of read pairs is sharded across chips, the
    direct analogue of PandaMux handing each worker thread its own
    pairs.
  * ``op`` axis (optional): the rows of the O(L^2) overlap plane — the
    forward-frame positions — are sharded too; partial diagonal count
    sums are exact integers, so a psum over "op" reassembles the
    full-plane counts bit-for-bit. This is the workload's
    sequence-parallel dimension (the reference has no analogue: its
    candidate loop is sequential per pair).

Both axes run the PRODUCTION kernel: the bodies below call the same
``plane_counts`` / ``lut_plane_sums`` / ``shortlist_from_counts``
helpers that the single-chip ``assemble_shortlist`` composes
(ops/fused2.py), so multi-chip output is byte-identical through host
finalization. STAT counters (pool.c:83-104) reduce with jax.lax.psum
(parallel/distributed.py) instead of per-thread tallies.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import fused2


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              op: int = 1, devices=None) -> Mesh:
    """Build a (dp, op) mesh over the first ``n_devices`` devices.

    dp shards the read-pair batch; op shards the overlap-plane rows.
    Default: all devices on the dp axis. Pass ``devices`` explicitly
    for a per-host local mesh in a multi-process runtime
    (jax.devices() is GLOBAL there — a mesh built from another
    process's devices deadlocks its collectives).
    """
    devs = jax.devices() if devices is None else list(devices)
    if n_devices is None:
        n_devices = len(devs)
    if dp is None:
        dp = n_devices // op
    assert dp * op == n_devices, (dp, op, n_devices)
    return Mesh(np.asarray(devs[:n_devices]).reshape(dp, op), ("dp", "op"))


def _sharded_body(nt_pack, fr_q, rr_q, flen, rlen, fo, ro, *, L, O,
                  SL, minoverlap, maxoverlap, num_kmers, algo_kind,
                  pmatch, pmismatch, nn_term, band, lut_match,
                  lut_mismatch):
    """Per-shard body: this shard holds a dp-slice of the batch
    (replicated over op) and computes plane rows [j0, j0+Oj) of the
    overlap plane; exact integer partial sums psum over "op" into the
    full-plane counts, after which scoring/shortlisting runs replicated
    (it is O(B*O) — negligible next to the O(B*O^2) plane)."""
    n_op = jax.lax.axis_size("op")
    op_idx = jax.lax.axis_index("op")
    assert O % n_op == 0, (O, n_op)
    Oj = O // n_op
    j0 = op_idx * Oj

    flen = flen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    nts = nt_pack.astype(jnp.int32) & 0xFF
    nt_f = nts & 0x0F
    nt_r = (nts >> 4) & 0x0F
    # O(L) k-mer seeding replicated over op (windows cross row blocks)
    Fkm, Rkm = fused2.kmer_frames(nt_f, nt_r, flen, rlen, L, num_kmers)
    m, unk, candc = fused2.plane_counts(nt_f, nt_r, Fkm, Rkm, O,
                                        j0=j0, Oj=Oj)
    sums = jax.lax.psum(jnp.concatenate([m, unk, candc], axis=0), "op")
    B = nt_f.shape[0]
    m, unk, candc = sums[:B], sums[B:2 * B], sums[2 * B:]
    lutsum = None
    if algo_kind in ("pear", "rdp_mle"):
        lutsum = jax.lax.psum(
            fused2.lut_plane_sums(fr_q, rr_q, nt_f, nt_r, flen, rlen,
                                  L, O, algo_kind, lut_match,
                                  lut_mismatch, nn_term, j0=j0, Oj=Oj),
            "op")
    return fused2.shortlist_from_counts(
        m, unk, candc, lutsum, flen, rlen, fo.astype(jnp.int32),
        ro.astype(jnp.int32), O=O, SL=SL, minoverlap=minoverlap,
        maxoverlap=maxoverlap, algo_kind=algo_kind, pmatch=pmatch,
        pmismatch=pmismatch, nn=float(fused2.tables
                                      .QUAL_NN_SIMPLE_BAYESIAN),
        band=band)


def _sharded_cand_body(nt_pack, flen, rlen, *, L, O, num_kmers):
    """Sparse LUT-path shard body: per-shard k-mer candidate plane rows
    psum over "op" (partial diagonal sums are exact integers), then the
    bitmask packing — the multi-chip twin of
    ops/fused2.assemble_candidates_nt."""
    n_op = jax.lax.axis_size("op")
    op_idx = jax.lax.axis_index("op")
    assert O % n_op == 0, (O, n_op)
    Oj = O // n_op
    j0 = op_idx * Oj

    flen = flen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    nts = nt_pack.astype(jnp.int32) & 0xFF
    nt_f = nts & 0x0F
    nt_r = (nts >> 4) & 0x0F
    Fkm, Rkm = fused2.kmer_frames(nt_f, nt_r, flen, rlen, L, num_kmers)
    candc = jax.lax.psum(
        fused2.plane_cand(Fkm, Rkm, O, j0=j0, Oj=Oj), "op")
    return fused2.pack_bits16(candc != 0, O)


def _sharded_cand_body_packed4(plane4, flen, rlen, *, L, O, num_kmers):
    """Production-upload twin of _sharded_cand_body: the 4-bit packed
    [fwd2 | rev2] plane (psq_pack4 / assemble_candidates_packed4 —
    N-containing rows are host-recomputed exactly as single-chip)."""
    n_op = jax.lax.axis_size("op")
    op_idx = jax.lax.axis_index("op")
    assert O % n_op == 0, (O, n_op)
    Oj = O // n_op
    j0 = op_idx * Oj

    flen = flen.astype(jnp.int32)
    rlen = rlen.astype(jnp.int32)
    cf, cr, nonn = fused2._unpack2bit(plane4, L)
    Fkm, Rkm = fused2.kmer_frames_codes(cf, nonn, cr, nonn, flen, rlen,
                                        L, num_kmers)
    candc = jax.lax.psum(
        fused2.plane_cand(Fkm, Rkm, O, j0=j0, Oj=Oj), "op")
    return fused2.pack_bits16(candc != 0, O)


def make_sharded_cand_step_packed4(mesh: Mesh, L: int,
                                   O: int | None = None,
                                   num_kmers: int = 2):
    """Jit the PRODUCTION sparse candidate step (4-bit packed upload)
    over ``mesh`` — bit-identical to assemble_candidates_packed4; the
    engine (BatchAssembler._dispatch) uses this when its mesh has an
    "op" axis wider than 1."""
    if O is None:
        O = L
    body = functools.partial(_sharded_cand_body_packed4, L=L, O=O,
                             num_kmers=num_kmers)
    bspec = P("dp")
    return jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(bspec,) * 3,
                      out_specs=bspec, check_vma=False))


def make_sharded_cand_step(mesh: Mesh, L: int, O: int | None = None,
                           num_kmers: int = 2):
    """Jit the sparse LUT candidate step over ``mesh`` (dp batch axis,
    op overlap-plane-row axis). Returns ``step(nt_pack, flen, rlen) ->
    [B, O//32]`` — bit-identical to assemble_candidates_nt."""
    if O is None:
        O = L
    body = functools.partial(_sharded_cand_body, L=L, O=O,
                             num_kmers=num_kmers)
    bspec = P("dp")
    return jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(bspec,) * 3,
                      out_specs=bspec, check_vma=False))


def make_sharded_step(mesh: Mesh, L: int, O: int | None = None,
                      SL: int = fused2.SHORTLIST, minoverlap: int = 2,
                      maxoverlap: int = 0, num_kmers: int = 2,
                      algo_kind: str = "counts", pmatch: float = 0.0,
                      pmismatch: float = 0.0, nn_term: float = 0.0,
                      band: float | None = None, lut_match=None,
                      lut_mismatch=None):
    """Jit the production shortlist step over ``mesh``: batch sharded
    over dp, overlap-plane rows over op. Returns ``step(nt_pack, fr_q,
    rr_q, flen, rlen, fo, ro) -> [B, 2*SL+4]`` (nt_pack = fwd|rev<<4
    nibble plane) — bit-identical to ops/fused2.assemble_shortlist on
    one device.
    """
    if O is None:
        O = L
    if band is None:
        band = fused2.BAND_LUT if algo_kind in ("pear", "rdp_mle") \
            else fused2.BAND_COUNTS
    body = functools.partial(
        _sharded_body, L=L, O=O, SL=SL, minoverlap=minoverlap,
        maxoverlap=maxoverlap, num_kmers=num_kmers, algo_kind=algo_kind,
        pmatch=pmatch, pmismatch=pmismatch, nn_term=nn_term, band=band,
        lut_match=lut_match, lut_mismatch=lut_mismatch)
    bspec = P("dp")
    step = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(bspec,) * 7,
            out_specs=bspec,
            check_vma=False))
    return step


def shard_fused_batch(mesh: Mesh, asm, batch):
    """Run the PRODUCTION fused step with the read-pair batch sharded
    over the mesh's dp axis — XLA partitions the whole graph (every op
    is batch-parallel) and each chip scores its shard; host
    finalization then proceeds exactly as single-chip.

    `asm` is a BatchAssembler; `batch` an assembler.Batch whose B is
    divisible by the dp size. Returns (st, dev) ready for
    asm._finalize.
    """
    prev = asm.mesh
    asm.mesh = mesh
    try:
        st = asm._pre(batch)
        dev = asm._dispatch(st)  # device_puts inputs NamedSharding(dp);
        # the host-side batch arrays stay numpy for native finalize
    finally:
        asm.mesh = prev
    return st, dev


def shard_batch(mesh: Mesh, arrays):
    """Place host numpy arrays on the mesh with batch-dim sharding."""
    out = []
    for a in arrays:
        spec = P("dp") if a.ndim >= 1 else P()
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
