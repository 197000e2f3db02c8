#!/usr/bin/env python3
"""Smoke run of the read-merge path on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below but the last
    python chip_smoke.py --four    # four cards: the dp=4 mesh phase only

Everything runs in this one process, which holds the card: a second JAX
process would find most of the card's memory reserved. The CLI is
therefore driven in-process through ``pandaseq_tpu.cli.main``. Phases,
each of which raises on failure:

  environment  card name and power limit (nvidia-smi), jax.devices(), a
               GPU platform (no CPU fallback), the native host library
  kernels      the candidate kernels (list, mask, sorted join,
               pack_bits16) at B=16384, L=O=256, k in {1, 2}, equal to
               the native host twin (psq_cand_mask) on every row the
               device serves; the dense shortlist kernels' merged bytes
               equal to oracle.assemble on a sample, and their f32 LUT
               sums within BAND_LUT of an f64 numpy reference; each
               kernel's median time over REPS runs
  end to end   the CLI on generated MiSeq-like 2x250 pairs with the
               device engine pinned and the host work-steal off,
               sha256-equal to the host engine and record-equal to
               oracle.assemble on a sample
  four cards   (--four) run_distributed over a dp=4 mesh, compared as a
               record multiset with one card over the same stream

Inputs come from tests/golden/make_data.py --fast with fixed seeds and
are written under build/chip_smoke/. The last line of stdout is
{"ok": true, "device": {...}}, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 11
KERNEL_BATCH = 16384
E2E_PAIRS = 200_000
K0_PAIRS = 32_768
FOUR_PAIRS = 200_000
ORACLE_SAMPLE = 2_000
LUT_ROWS = 4_096  # rows whose every offset the f64 LUT reference checks
REPS = 10


def card_lines() -> list[str]:
    """nvidia-smi's name and power limit, one line per card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return ["nvidia-smi unavailable (%s)" % e]
    out = r.stdout.strip()
    return out.splitlines() if r.returncode == 0 and out \
        else ["nvidia-smi failed: %s" % r.stderr.strip()]


def environment(n_cards: int) -> str:
    """Print the card and the devices; fail without a GPU or without the
    native library. Returns the card line that timings are tagged
    with."""
    cards = card_lines()
    for line in cards:
        print("card:", line, flush=True)
    import jax
    devs = jax.devices()
    print("jax.devices():", devs, flush=True)
    if devs[0].platform != "gpu":
        raise SystemExit("no GPU: JAX runs on %r" % devs[0].platform)
    if len(devs) < n_cards:
        raise SystemExit("need %d cards, JAX sees %d" % (n_cards, len(devs)))
    sys.path.insert(0, ROOT)
    import pandaseq_tpu
    if os.path.dirname(os.path.abspath(pandaseq_tpu.__file__)) \
            != os.path.join(ROOT, "pandaseq_tpu"):
        raise SystemExit("pandaseq_tpu is not this checkout's: %s"
                         % pandaseq_tpu.__file__)
    from pandaseq_tpu.io import native
    if native.get_lib() is None:
        raise SystemExit("native host library did not build:\n%s"
                         % native.build_error)
    from pandaseq_tpu.runtime import enable_compilation_cache
    print("compile cache:", enable_compilation_cache(), flush=True)
    return cards[0]


def make_data(pairs: int, seed: int) -> tuple[str, str]:
    """Generated MiSeq-like 2x250 pairs (amplicons 300-460 bp)."""
    prefix = os.path.join(WORK, "smoke_%d_%d" % (pairs, seed))
    f1, f2 = prefix + "_1.fastq", prefix + "_2.fastq"
    if not os.path.exists(f2):
        os.makedirs(WORK, exist_ok=True)
        subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests", "golden",
                                          "make_data.py"),
             "--fast", "--pairs", str(pairs), "--seed", str(seed),
             "--out-prefix", prefix],
            check=True, stdout=subprocess.DEVNULL)
    return f1, f2


def first_batch(f1: str, f2: str, B: int):
    from pandaseq_tpu.io import native
    rdr = native.NativeBatchReader(f1, f2, batch=B, L=512)
    batch = next(rdr)
    rdr.close()
    return batch


def median_ms(fn, reps: int) -> float:
    """Median wall ms of fn() over reps runs, each ending in
    block_until_ready (after one untimed compile/warm-up call)."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _first_offsets(bits, C):
    """(count, first C offsets ascending, 0-padded) per row of a [B, O]
    0/1 candidate plane (bit j = offset j+1)."""
    import numpy as np
    O = bits.shape[1]
    big = O + 1
    offs = np.where(bits != 0, np.arange(1, O + 1)[None, :], big)
    first = np.sort(offs, axis=1)[:, :C]
    return bits.sum(axis=1), np.where(first == big, 0, first)


def check_candidate_kernels(batch, reps: int = REPS, card: str = ""):
    """Every candidate kernel against the native host twin, with 0
    differences on the rows the device serves (rows without N: the
    4-bit upload carries no N positions, and the engine recomputes the
    others on the host). Returns {kernel: median ms}."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pandaseq_tpu.assembler import BatchAssembler
    from pandaseq_tpu.io import native
    from pandaseq_tpu.ops import fused2

    st = BatchAssembler(L=512, host_only=False)._pre(batch)
    B, L, O = st["B"], st["Lb"], st["O"]
    plane4, hasN = native.pack4(batch, L)
    served = ~hasN
    args = tuple(jax.device_put(np.asarray(a)) for a in
                 (plane4, batch.flen, batch.rlen))
    C = fused2.CAND_LIST_C
    times = {}

    @functools.partial(jax.jit, static_argnames=("num_kmers",))
    def join(plane, flen, rlen, num_kmers):
        cf, cr, nonn = fused2._unpack2bit(plane, L)
        return fused2.cand_mask_join(
            cf, nonn, cr, nonn, flen.astype(jnp.int32),
            rlen.astype(jnp.int32), L, O, num_kmers)

    for k in (1, 2):
        host = native.cand_mask(batch, np.arange(B), k, O)
        bits = np.unpackbits(host.view(np.uint8), axis=1,
                             bitorder="little")[:, :O]
        count, first = _first_offsets(bits, C)
        kernels = {
            "list": functools.partial(
                fused2.assemble_candidates_list_packed4, *args, L=L, O=O,
                num_kmers=k),
            "mask": functools.partial(
                fused2.assemble_candidates_packed4, *args, L=L, O=O,
                num_kmers=k),
            "join": functools.partial(join, *args, num_kmers=k),
        }
        lst = np.asarray(kernels["list"]()).astype(np.int64)
        bad = {"list": int(((lst[:, 0] != count)
                            | (lst[:, 1:1 + C] != first).any(axis=1))
                           [served].sum())}
        for name in ("mask", "join"):
            got = np.asarray(kernels[name]())
            bad[name] = int((got != host).any(axis=1)[served].sum())
        print("k=%d: rows differing from the host twin %s over %d served "
              "rows (B=%d, L=O=%d)" % (k, bad, int(served.sum()), B, O),
              flush=True)
        if any(bad.values()):
            raise AssertionError("candidate kernels differ from the host "
                                 "twin at k=%d: %s" % (k, bad))
        if k == 2:
            for name, fn in kernels.items():
                times[name] = median_ms(fn, reps)
    times["host_twin"] = median_ms(functools.partial(
        native.cand_mask, batch, np.arange(B), 2, O), reps)

    # pack_bits16 sums distinct powers of two in a wrapping s32 dot:
    # random planes set bit 31 of half the words
    rng = np.random.default_rng(SEED)
    nz = (rng.random((B, O)) < 0.5).astype(np.int32)
    want = np.packbits(nz.astype(np.uint8), axis=1,
                       bitorder="little").view("<i4")
    nz_d = jax.device_put(nz)
    pack = jax.jit(functools.partial(fused2.pack_bits16, O=O))
    n_bad = int((np.asarray(pack(nz_d)) != want).any(axis=1).sum())
    print("pack_bits16: %d of %d rows differ from np.packbits"
          % (n_bad, B), flush=True)
    if n_bad:
        raise AssertionError("pack_bits16 is not exact on this device")
    times["pack_bits16"] = median_ms(functools.partial(pack, nz_d), reps)
    for name, ms in times.items():
        print("time %-12s median %.3f ms per %d-pair batch (%d runs)  [%s]"
              % (name, ms, B, reps, card), flush=True)
    return times


def lut_sums_f64(fr_q, rr_q, nt_f, nt_r, flen, rlen, O, kind, lut_m,
                 lut_mm, nn_term):
    """Plain numpy f64 twin of fused2.lut_plane_sums: per-base LUT score
    sums for every overlap offset, [B, O]."""
    import numpy as np
    B, L = fr_q.shape
    qf = np.clip(fr_q[:, :O].astype(np.int64), 0, 46)
    if kind == "pear":  # both quals from the forward buffer
        x = rlen[:, None] - 1 - np.arange(O)[None, :]
        idx = np.where(x < flen[:, None], flen[:, None] - 1 - x, x)
        q2 = np.take_along_axis(fr_q.astype(np.int64),
                                np.clip(idx, 0, L - 1), axis=1)
    else:
        q2 = rr_q[:, :O].astype(np.int64)
    q2 = np.clip(q2, 0, 46)
    f = nt_f[:, :O, None]
    r = nt_r[:, None, :O]
    pad = (f == 0) | (r == 0)
    raw = (f & r) != 0
    contrib = np.where(raw, lut_m[qf[:, :, None], q2[:, None, :]],
                       lut_mm[qf[:, :, None], q2[:, None, :]])
    if kind == "pear":
        contrib = np.where(((f == 15) | (r == 15)) & ~pad, nn_term,
                           contrib)
    contrib = np.where(pad, 0.0, contrib)
    out = np.zeros((B, O))
    for j in range(O):  # overlap o = j + i + 1 -> column j + i
        out[:, j:] += contrib[:, j, :O - j]
    return out


def fasta_records(payload: bytes) -> list[bytes]:
    lines = payload.split(b"\n")
    return [lines[i] + b"\n" + lines[i + 1] + b"\n"
            for i in range(0, len(lines) - 1, 2)]


def oracle_record(cfg, pair):
    from pandaseq_tpu import oracle
    from pandaseq_tpu.io.output import format_fasta
    res, code = oracle.assemble(cfg, pair)
    return format_fasta(res) if code == "OK" else None


def check_dense_kernels(batch, sample: int = ORACLE_SAMPLE,
                        lut_rows: int = LUT_ROWS, reps: int = REPS,
                        card: str = ""):
    """The dense shortlist kernels (-k 0, and pear/rdp_mle when the
    native candidate path is unavailable), finalized by the native f64
    selection: merged bytes equal to oracle.assemble on a sample, and
    the f32 LUT sums within BAND_LUT of f64. Returns {kernel: ms}."""
    import jax
    import numpy as np

    from pandaseq_tpu import oracle
    from pandaseq_tpu.assembler import BatchAssembler
    from pandaseq_tpu.ops import fused2

    B = len(batch.sids)
    rng = np.random.default_rng(SEED)
    rows = np.sort(rng.choice(B, size=min(sample, B), replace=False))
    times = {}
    for algo, k in (("pear", 2), ("rdp_mle", 2), ("simple_bayesian", 0)):
        cfg = oracle.OracleConfig(algorithm=oracle.make_algorithm(algo),
                                  num_kmers=k)
        asm = BatchAssembler(cfg, L=512, host_only=False)
        st = asm._pre(batch)
        L, O = st["Lb"], st["O"]
        lut = algo in ("pear", "rdp_mle")
        plane = jax.device_put(asm._dense_plane(st, lut))
        fo32 = st["fo"].astype(np.int32)
        ro32 = st["ro"].astype(np.int32)

        def launch():
            return asm._launch(False, lut, plane, batch.flen, batch.rlen,
                               fo32, ro32, L, O)

        st["plane_kind"] = 0
        codes, payload, _ = asm._finalize(st, launch(), emit="fasta")
        ok_rows = [i for i, (c, _) in enumerate(codes) if c == "OK"]
        recs = fasta_records(payload)
        if len(recs) != len(ok_rows):
            raise AssertionError("%s: %d records for %d OK rows"
                                 % (algo, len(recs), len(ok_rows)))
        got = dict(zip(ok_rows, recs))
        bad = sum(got.get(int(b)) != oracle_record(cfg, batch.pairs[b])
                  for b in rows)
        name = "shortlist_%s_k%d" % (algo, k)
        print("%s: %d of %d sampled records differ from the oracle "
              "(%d OK of %d)" % (name, bad, len(rows), len(ok_rows), B),
              flush=True)
        if bad:
            raise AssertionError("%s differs from the oracle" % name)
        times[name] = median_ms(launch, reps)
        if lut:
            n = min(lut_rows, B)
            ntp = batch.nt_packed()[:n, :L].astype(np.int32) & 0xFF
            host = dict(fr_q=batch.fwd_q[:n, :L], rr_q=batch.rev_q[:n, :L],
                        nt_f=ntp & 0x0F, nt_r=(ntp >> 4) & 0x0F,
                        flen=batch.flen[:n].astype(np.int32),
                        rlen=batch.rlen[:n].astype(np.int32))
            sums = jax.jit(functools.partial(
                fused2.lut_plane_sums, L=L, O=O, algo_kind=algo,
                lut_match=asm._lut_m, lut_mismatch=asm._lut_mm,
                nn_term=asm._nn_term))
            f32 = np.asarray(sums(**{a: jax.device_put(v)
                                     for a, v in host.items()}))
            f64 = np.concatenate([
                lut_sums_f64(**{a: v[i:i + 256] for a, v in host.items()},
                             O=O, kind=algo, lut_m=asm._lut_m,
                             lut_mm=asm._lut_mm, nn_term=asm._nn_term)
                for i in range(0, n, 256)])
            err = float(np.abs(f32.astype(np.float64) - f64).max())
            print("lut_plane_sums %s: max |f32 - f64| = %.6g over %d rows "
                  "x %d offsets, BAND_LUT %.3g; the band was never "
                  "checked against a GPU's reduction order before; "
                  "Precision.HIGHEST is full f32 on a GPU, not TF32  "
                  "[%s]" % (algo, err, n, O, fused2.BAND_LUT, card),
                  flush=True)
            if not err < fused2.BAND_LUT:
                raise AssertionError("LUT sums outside BAND_LUT")
    for name, ms in times.items():
        print("time %-30s median %.3f ms per %d-pair batch (%d runs)  [%s]"
              % (name, ms, B, reps, card), flush=True)
    return times


def run_cli(argv: list[str], engine: str):
    """One in-process CLI run with the engine pinned and the host
    work-steal off. Returns (rc, seconds, the run's BatchAssembler)."""
    os.environ["PANDASEQ_TPU_ENGINE"] = engine
    os.environ["PANDASEQ_TPU_HYBRID"] = "0"
    from pandaseq_tpu.cli import main as cli
    made = []
    base = cli.BatchAssembler

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    cli.BatchAssembler = Recording
    try:
        t0 = time.perf_counter()
        rc = cli.run(cli.parse_args(argv), argv)
        dt = time.perf_counter() - t0
    finally:
        cli.BatchAssembler = base
    return rc, dt, made[0]


def check_against_oracle(cfg, f1, f2, out_path, sample: int):
    """Records of the CLI output equal oracle.assemble formatted with
    io/output.py on ``sample`` pairs spread over the input (decoded by
    the independent Python FASTQ reader)."""
    import numpy as np

    from pandaseq_tpu.io import fastq
    with open(out_path, "rb") as fh:
        recs = fasta_records(fh.read())
    by_id = {r.split(b";", 1)[0][1:]: r for r in recs}
    n = sum(1 for _ in open(f1, "rb")) // 4
    rng = np.random.default_rng(SEED)
    want = set(rng.choice(n, size=min(sample, n), replace=False).tolist())
    bad = seen = 0
    for i, pair in enumerate(fastq.read_pairs(f1, f2)):
        if i not in want:
            continue
        seen += 1
        if by_id.get(str(pair.sid).encode()) != oracle_record(cfg, pair):
            bad += 1
    if seen != len(want) or bad:
        raise AssertionError("%d of %d sampled records differ from the "
                             "oracle" % (bad, seen))
    return seen


def end_to_end(card: str):
    from pandaseq_tpu import oracle
    big = make_data(E2E_PAIRS, SEED)
    small = make_data(K0_PAIRS, SEED + 1)
    runs = [("simple_bayesian", [], big, oracle.OracleConfig()),
            ("pear", ["-A", "pear"], big, oracle.OracleConfig(
                algorithm=oracle.make_algorithm("pear"))),
            ("k0", ["-k", "0"], small, oracle.OracleConfig(num_kmers=0))]
    for name, flags, (f1, f2), cfg in runs:
        n = sum(1 for _ in open(f1, "rb")) // 4
        digests = {}
        for tag, engine in (("device", "device"), ("host", "host"),
                            ("device-warm", "device")):
            out = os.path.join(WORK, "%s_%s.fasta" % (name, tag))
            argv = ["-f", f1, "-r", f2, "-w", out, "-g", out + ".log",
                    *flags]
            rc, dt, asm = run_cli(argv, engine)
            if rc != 0:
                raise AssertionError("%s %s: CLI exit %d" % (name, tag, rc))
            if asm.engine != engine or asm._host_steals:
                raise AssertionError(
                    "%s %s: engine %s (%s), %d host steals"
                    % (name, tag, asm.engine, asm.engine_info,
                       asm._host_steals))
            with open(out, "rb") as fh:
                digests[tag] = hashlib.sha256(fh.read()).hexdigest()
            print("e2e %-16s %-11s %d pairs in %.2f s = %.0f pairs/s "
                  "(engine %s, %d host steals; %s)  [%s]"
                  % (name, tag, n, dt, n / dt, asm.engine,
                     asm._host_steals,
                     "includes compilation" if tag == "device"
                     else "reading", card), flush=True)
        if len(set(digests.values())) != 1:
            raise AssertionError("%s: device and host outputs differ: %s"
                                 % (name, digests))
        seen = check_against_oracle(
            cfg, f1, f2, os.path.join(WORK, "%s_device.fasta" % name),
            ORACLE_SAMPLE)
        print("e2e %s: device == host (sha256 %s), %d sampled records "
              "== oracle" % (name, digests["device"][:16], seen),
              flush=True)


def four_cards(card: str):
    """run_distributed over a dp=4, op=1 mesh of the four cards vs one
    card on the same stream, as an order-independent record multiset."""
    import jax
    import numpy as np

    from pandaseq_tpu.assembler import BatchAssembler
    from pandaseq_tpu.parallel import distributed as D
    from pandaseq_tpu.parallel import shard

    os.environ["PANDASEQ_TPU_HYBRID"] = "0"
    f1, f2 = make_data(FOUR_PAIRS, SEED + 2)
    batch = first_batch(f1, f2, 4096)
    mesh = shard.make_mesh(4, op=1)
    asm4 = BatchAssembler(L=512, mesh=mesh)
    dev = asm4._dispatch(asm4._pre(batch))
    n_dev = len(dev.sharding.device_set)
    one = BatchAssembler(L=512, host_only=False)
    ref = one._dispatch(one._pre(batch))
    if n_dev != 4 or not np.array_equal(np.asarray(dev), np.asarray(ref)):
        raise AssertionError("dp=4 dispatch on %d devices differs from one "
                             "card" % n_dev)
    out_dir = os.path.join(WORK, "four")
    t0 = time.perf_counter()
    vec, _ = D.run_distributed([(f1, f2)], out_dir=out_dir, batch=4096,
                               op=1)
    dt = time.perf_counter() - t0
    with open(os.path.join(out_dir, "part-00000.fasta"), "rb") as fh:
        four = fasta_records(fh.read())
    single = BatchAssembler(L=512, host_only=False)
    t1 = time.perf_counter()
    buf = bytearray()
    for _, _, payload in single.emit_stream(
            D._batches_of(f1, f2, 4096, 512), fmt="fasta"):
        buf += payload
    dt1 = time.perf_counter() - t1
    one_card = fasta_records(bytes(buf))

    def multiset(recs):
        return hashlib.sha256(b"".join(sorted(recs))).hexdigest()

    if int(vec[0]) != FOUR_PAIRS or multiset(four) != multiset(one_card):
        raise AssertionError("four-card output differs from one card")
    print("four cards: dp=4 dispatch on %d devices; run_distributed %d "
          "pairs in %.2f s = %.0f pairs/s (includes compilation); one "
          "card %.2f s; %d records, multiset sha256 %s equal  [%s]"
          % (n_dev, FOUR_PAIRS, dt, FOUR_PAIRS / dt, dt1, len(four),
             multiset(four)[:16], card), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card dp=4 phase")
    args = ap.parse_args(argv)
    card = environment(4 if args.four else 1)
    if args.four:
        four_cards(card)
    else:
        f1, f2 = make_data(KERNEL_BATCH, SEED + 3)
        batch = first_batch(f1, f2, KERNEL_BATCH)
        check_candidate_kernels(batch, card=card)
        check_dense_kernels(batch, card=card)
        end_to_end(card)
    import jax
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
