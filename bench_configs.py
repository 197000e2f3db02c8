"""Extended benchmark matrix (BASELINE.md configs 2-4).

Measures read-pairs/s for:
  1. default simple_bayesian          (same as bench.py headline)
  2. + primers (-p/-q) + min_phred + min_overlapbits filters
  3. PEAR (-A pear) + pear_test plugin
  4. RDP-MLE and UPARSE

Writes build/bench_extra.json and prints one JSON line per config to stderr;
stdout stays empty (bench.py owns the driver-facing line).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
BATCH = int(os.environ.get("BENCH_BATCH", "8192"))
N_PAIRS = int(os.environ.get("BENCH_PAIRS", str(BATCH * 12)))
DEPTH = int(os.environ.get("BENCH_DEPTH", "3"))
FWD_PRIMER = "GTGCCAGCMGCCGCGGTAA"
REV_PRIMER = "GGACTACHVGGGTWTCTAAT"


def log(m):
    print(m, file=sys.stderr, flush=True)


def ensure_data(prefix, extra=()):
    p1 = os.path.join(DATA, prefix + "_1.fastq")
    if not (os.path.exists(p1)
            and sum(1 for _ in open(p1)) == 4 * N_PAIRS):
        subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests", "golden",
                                          "make_data.py"),
             "--pairs", str(N_PAIRS), "--seed", "23",
             "--out-prefix", os.path.join(DATA, prefix), *extra],
            check=True, cwd=ROOT, stdout=subprocess.DEVNULL)
    return p1, os.path.join(DATA, prefix + "_2.fastq")


def run_config(name, f1, f2, cfg, modules, use_emit):
    from pandaseq_tpu.assembler import BatchAssembler
    from pandaseq_tpu.io import native
    from pandaseq_tpu.io import output as out_mod
    from pandaseq_tpu.io.prefetch import prefetch

    def batches():
        yield from native.NativeBatchReader(f1, f2, batch=BATCH, L=512,
                                            ring=2 * DEPTH + 10)

    asm = BatchAssembler(cfg, L=512, modules=list(modules))
    # warm
    if use_emit:
        for _ in asm.emit_stream(batches(), depth=DEPTH):
            pass
    else:
        for b in batches():
            asm.assemble_batch(b)
            break
    best = 0.0
    for _ in range(int(os.environ.get("BENCH_CFG_PASSES", "3"))):
        for mod in modules:
            mod.rejected = 0
        asm = BatchAssembler(cfg, L=512, modules=list(modules))
        t0 = time.perf_counter()
        n = 0
        if use_emit:
            for _, codes, payload in asm.emit_stream(
                    prefetch(asm.pre_stream(batches())), depth=DEPTH,
                    threaded=True):
                n += len(codes)
        else:
            for _, results in asm.assemble_stream(
                    prefetch(asm.pre_stream(batches())), depth=DEPTH,
                    threaded=True):
                for code, res in results:
                    n += 1
                    if code == "OK":
                        out_mod.format_fasta(res)
        dt = time.perf_counter() - t0
        best = max(best, n / dt)
        time.sleep(8)
    rec = {"config": name, "pairs_per_sec": round(best, 1),
           "pairs": n, "ok": asm.counters.ok}
    log(json.dumps(rec))
    return rec


def main():
    from pandaseq_tpu import filters, oracle, stats
    from pandaseq_tpu.nt import nt_from_ascii, nt_from_ascii_complement
    from pandaseq_tpu.runtime import enable_compilation_cache
    import numpy as np
    enable_compilation_cache()

    plain = ensure_data("benchx")
    primed = ensure_data("benchxp", ("--fwd-primer", FWD_PRIMER,
                                     "--rev-primer", REV_PRIMER))
    logger = stats.LogProxy(open(os.devnull, "wb"))
    results = []

    results.append(run_config(
        "simple_bayesian", *plain, oracle.OracleConfig(), (), True))

    # min_overlapbits compares the RDP-MLE bits score (Cole 2013), so it
    # pairs with -A rdp_mle; with log-prob algorithms it rejects all (as
    # in the reference)
    cfg2 = oracle.OracleConfig(
        algorithm=oracle.make_algorithm("rdp_mle"),
        forward_primer=nt_from_ascii(
            np.frombuffer(FWD_PRIMER.encode(), dtype=np.uint8)),
        reverse_primer=nt_from_ascii_complement(
            np.frombuffer(REV_PRIMER.encode(), dtype=np.uint8)))
    mods2 = [filters.load_module("min_overlapbits", logger),
             filters.load_module("completely_miss_the_point:4", logger)]
    # module configs ride the emit fast path too: every built-in
    # check-stage module has a vectorized check_batch
    results.append(run_config("primers+filters", *primed, cfg2, mods2,
                              True))

    cfg3 = oracle.OracleConfig(algorithm=oracle.make_algorithm("pear"))
    mods3 = [filters.load_module("pear_test", logger)]
    results.append(run_config("pear+pear_test", *plain, cfg3, mods3,
                              True))

    for algo in ("rdp_mle", "uparse"):
        cfg = oracle.OracleConfig(algorithm=oracle.make_algorithm(algo))
        results.append(run_config(algo, *plain, cfg, (), True))

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "bench_extra.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    log("wrote build/bench_extra.json")


if __name__ == "__main__":
    main()
