"""Multi-host data-parallel driver.

The reference's scaling story is one node of pthreads over a mutex'd
reader (pool.c/mux.c). Here (SURVEY.md §2.4): every host decodes its
input shard, every device assembles its share of the batch, and the
STAT counters + overlap histogram are reduced with a device-axis sum
at the end — output streams stay host-local (the threaded
reference's output order is already nondeterministic, so per-host files
match its semantics).

Input sharding, mirroring PandaMux's one-stream/N-consumers semantics
(mux.c:132-161 hands each worker the next pair under a mutex):

  * more file pairs than hosts -> files are striped across hosts;
  * ONE file pair, N hosts -> every host decodes the stream (the
    native decoder runs at ~150k pairs/s, far above one chip's share)
    and claims batches round-robin by batch index — each record is
    processed by exactly one host, like the reference's mutex'd
    hand-off but deterministic.

Checkpoint/resume: the driver records (shard, batch_index) after every
flushed batch in a sidecar; on restart batches before the watermark are
skipped — append-only output makes this exact (SURVEY.md §5).
"""

from __future__ import annotations

import json
import os

import numpy as np


def maybe_initialize_distributed():
    """jax.distributed.initialize when a cluster env is present. A
    failed initialisation raises: a host that silently ran alone would
    write a partial output as if it were the whole."""
    import jax
    addr = (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS"))
    if addr:
        jax.distributed.initialize(coordinator_address=addr)
    return jax.process_index(), jax.process_count()


def reduce_counters(counters, histogram: dict, modules=()):
    """Global STAT reduction: psum the counter vector + histogram +
    per-module reject tallies over all hosts (proxy.c's per-thread
    tallies reduced; module.c:208-216 prints each module's rejects in
    the final STAT block, so those reduce too — each module object's
    ``rejected`` is REPLACED with the global total).

    Each process contributes its vector on its FIRST local device's row
    of a device-sharded [n_devices, len] array (other rows zero), so
    the reduction is a plain device-axis sum — correct for any number
    of local devices per process, even uneven ones."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    # merged reads cap at 2*MAX_LEN-1 = 899 nt so every overlap fits;
    # fail loudly rather than silently dropping a histogram bin
    assert all(0 <= o < 1024 for o in histogram), \
        "overlap histogram bin out of range"
    modules = list(modules)
    vec = np.zeros(8 + 1024 + len(modules), dtype=np.int32)
    vec[0:8] = [counters.count, counters.ok, counters.noalgn,
                counters.lowq, counters.badread, counters.slow,
                counters.nofp, counters.norp]
    for o, n in histogram.items():
        vec[8 + o] = n
    for i, m in enumerate(modules):
        vec[8 + 1024 + i] = m.rejected

    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, ("dp",))
    n_local = max(jax.local_device_count(), 1)
    local = np.zeros((n_local, len(vec)), dtype=np.int32)
    local[0] = vec
    arr = jax.make_array_from_process_local_data(
        jax.NamedSharding(mesh, P("dp")), local)
    total = jax.jit(
        lambda x: jnp.sum(x, axis=0, dtype=jnp.int32),
        out_shardings=jax.NamedSharding(mesh, P()))(arr)
    # total is replicated; np.asarray on an array spanning remote
    # devices raises in a real multi-process runtime — read this
    # process's own copy
    out = np.asarray(total.addressable_data(0))
    hist = {o: int(out[8 + o]) for o in range(1024) if out[8 + o] > 0}
    for i, m in enumerate(modules):
        m.rejected = int(out[8 + 1024 + i])
    return out[:8], hist


class ShardCheckpoint:
    """Append-only resume watermark per input shard."""

    def __init__(self, path: str | None):
        self.path = path
        self.done = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    rec = json.loads(line)
                    self.done[rec["shard"]] = rec["batch"]

    def watermark(self, shard: int) -> int:
        return self.done.get(shard, -1)

    def record(self, shard: int, batch: int):
        if not self.path:
            return
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"shard": shard, "batch": batch}) + "\n")
        self.done[shard] = batch


def shard_inputs(inputs, process_index: int, process_count: int):
    """inputs: list of (fwd, rev) path tuples -> this host's subset."""
    return [pair for i, pair in enumerate(inputs)
            if i % process_count == process_index]


def _claimed_batches(fwd, rev, batch, L, claim, n_claim, start_after,
                     ring=28):
    """(batch_index, Batch) for this host's round-robin claims on a
    shared stream. Unclaimed batches — and claimed batches at or below
    the resume watermark — are DECODE-SKIPPED via the native
    psq_skip_batch (line scan + record validation + persistent-qual
    replay, no row writes), so N hosts sharing one stream pay ~1/N of
    the full parse cost instead of N full decodes. The reference's mux
    serializes only the pair hand-off, never the parsing
    (mux.c:132-161); skip preserves every cross-batch semantic (error
    position, NODATA counting, stream flags, stale-qual tails), so
    claimed batches are bit-identical to the decode-everything layout.
    The ring needs to cover only CLAIMED batches in flight — skipped
    batches occupy no slots."""
    try:
        from ..io import native
        if native.get_lib() is None:
            raise RuntimeError
    except (RuntimeError, OSError):
        for i, b in enumerate(_batches_of(fwd, rev, batch, L,
                                          ring=ring)):
            if i % n_claim == claim and i > start_after:
                yield i, b
        return
    rdr = native.NativeBatchReader(fwd, rev, batch=batch, L=L, ring=ring)
    i = 0
    while True:
        if i % n_claim == claim and i > start_after:
            try:
                b = next(rdr)
            except StopIteration:
                break
            yield i, b
        elif rdr.skip_batch() == 0:
            break
        i += 1


def _batches_of(fwd, rev, batch, L, ring=28):
    try:
        from ..io import native
        if native.get_lib() is None:
            raise RuntimeError
        # ring: prefetch(8) + pipeline depth(6) + dispatch group(4) +
        # consumer < 28 batches in flight; persistent decode buffers.
        # CALLERS THAT SKIP BATCHES (mux round-robin claims) must scale
        # ring by the claim stride: the decoder cycles one slot per
        # DECODED batch, so n_claim-strided consumption holds each
        # claimed batch across n_claim slot reuses (a 5M-pair mux run
        # silently corrupted ~36k records before this was sized right;
        # the engine now also hard-fails on overrun).
        yield from native.NativeBatchReader(fwd, rev, batch=batch, L=L,
                                            ring=ring)
    except (RuntimeError, OSError):
        from ..io import fastq as fq
        reader = fq.read_pairs(fwd, rev)
        done = False
        while not done:
            chunk = []
            while len(chunk) < batch:
                try:
                    chunk.append(next(reader))
                except (StopIteration, fq.StreamError):
                    done = True
                    break
            if chunk:
                yield chunk


def run_distributed(inputs, cfg=None, out_dir: str = ".",
                    batch: int = 4096, L: int = 512, modules=(),
                    checkpoint: str | None = None, fastq: bool = False,
                    op: int = 1, perf_out: dict | None = None,
                    group: int = 4, depth: int = 6):
    """Assemble a list of (fwd, rev) FASTQ pairs across all hosts.

    Returns (counters_vector, histogram) reduced over every host; each
    module object's ``rejected`` is replaced by its global total
    (module.c:208-216's per-module STAT lines, reduced).
    Output is written per-host to out_dir/part-<process>.fasta.

    The per-host driver is the SAME byte fast path the CLI rides
    (emit_stream: native psq_finalize payload bytes, grouped
    mega-dispatch, threaded finalize) whenever the config allows it —
    stateless default configs stream at CLI speed per host; configs
    with python check-stage modules or post-assembly primers fall back
    to the general per-record path.

    With fewer file pairs than hosts, each pair's batch stream is
    claimed round-robin across the hosts sharing it (the PandaMux
    analogue, mux.c:132-161) so one input keeps every host busy.

    perf_out (optional dict) receives this host's wall seconds, pair
    count and pairs/s — the scaling-efficiency probe for BASELINE
    config 5.
    """
    import time as _time

    from .. import oracle
    from ..assembler import BatchAssembler
    from ..io import native as _native
    from ..io import output as out_mod
    from ..io.prefetch import prefetch

    pidx, pcount = maybe_initialize_distributed()
    inputs = list(inputs)
    cfg = cfg or oracle.OracleConfig()
    if len(inputs) >= pcount:
        my_inputs = [(i, pair, 0, 1)
                     for i, pair in enumerate(inputs)
                     if i % pcount == pidx]
    else:
        # mux mode: hosts gang up on the (few) streams; host h serves
        # stream h % n_inputs and claims batches round-robin among the
        # hosts on the same stream
        n_in = len(inputs)
        shard_no = pidx % n_in
        consumers = [p for p in range(pcount) if p % n_in == shard_no]
        my_inputs = [(shard_no, inputs[shard_no],
                      consumers.index(pidx), len(consumers))]
    import jax
    mesh = None
    if jax.local_device_count() > 1:
        from .shard import make_mesh
        # per-host LOCAL mesh: each host dp-shards its own batches
        # over its own chips only (jax.devices() is global in a
        # multi-process runtime). op > 1 additionally splits the
        # overlap-plane rows across chips (engine _dispatch_op).
        mesh = make_mesh(jax.local_device_count(), op=op,
                         devices=jax.local_devices())
    asm = BatchAssembler(cfg, L=L, modules=list(modules), mesh=mesh)
    fmt = out_mod.format_fastq if fastq else out_mod.format_fasta
    if checkpoint and pcount > 1:
        checkpoint = "%s.%05d" % (checkpoint, pidx)  # per-host sidecar
    ck = ShardCheckpoint(checkpoint)

    # byte fast path eligibility: same rule as the CLI (cli/main.py
    # use_emit) — pre-assembly primers only, every check-stage module
    # vectorized, native finalize present
    use_emit = (not cfg.post_primers and _native.get_lib() is not None
                and all(m.check is None or m.check_batch is not None
                        for m in asm.modules))
    emit_fmt = "fastq" if fastq else "fasta"

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "part-%05d.%s"
                            % (pidx, "fastq" if fastq else "fasta"))
    mode = "ab" if checkpoint and os.path.exists(out_path) else "wb"
    t0 = _time.perf_counter()
    n_pairs = 0
    with open(out_path, mode) as out:
        for shard_no, (fwd, rev), claim, n_claim in my_inputs:
            start_after = ck.watermark(shard_no)

            # round-robin batch claims + resume skip; unclaimed /
            # pre-watermark batches are decode-skipped inside the
            # generator (native psq_skip_batch), and the prefetch
            # thread runs both the decode and the skips — only CLAIMED
            # batches occupy ring slots, so no n_claim scaling
            stream = prefetch(_claimed_batches(
                fwd, rev, batch, L, claim, n_claim, start_after,
                ring=2 * depth + group + 16))
            idx_iter = []

            def tagged():
                for i, b in stream:
                    idx_iter.append(i)
                    yield b

            if use_emit:
                for _, codes, payload in asm.emit_stream(
                        prefetch(asm.pre_stream(tagged()), depth=depth
                                 + 2),
                        fmt=emit_fmt, depth=depth, threaded=True,
                        group=group):
                    batch_no = idx_iter.pop(0)
                    n_pairs += len(codes)
                    out.write(payload)
                    out.flush()
                    ck.record(shard_no, batch_no)
            else:
                for _, results in asm.assemble_stream(tagged(),
                                                      group=group):
                    batch_no = idx_iter.pop(0)
                    n_pairs += len(results)
                    for code, res in results:
                        if code == "OK":
                            out.write(fmt(res))
                    out.flush()
                    ck.record(shard_no, batch_no)

    if perf_out is not None:
        wall = _time.perf_counter() - t0
        perf_out.update(process=pidx, pairs=n_pairs, wall_s=wall,
                        pairs_per_sec=(n_pairs / wall if wall else 0.0))
    return reduce_counters(asm.counters, asm.counters.overlaps,
                           asm.modules)
