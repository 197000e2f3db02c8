"""BASELINE config 5: 10M-pair synthetic MiSeq 2x300, data-parallel
across N >= 2 hosts (BASELINE.md:34; the reference's regression-at-scale
discipline, testing/reg-test.vala:24).

It measures only the host path, on the CPU backend: every worker pins
JAX_PLATFORMS=cpu. Do not point it at one GPU from several processes —
each JAX process would reserve most of the card's memory, and the
second would fail.

Runs the SAME stream twice on the virtual CPU mesh:
  1. single process ("1 host"),
  2. N real OS processes coordinated by jax.distributed (Gloo), mux mode
     (one shared input pair, round-robin batch claims — mux.c:132-161),
and verifies the union of the N part files is record-for-record
identical to the single-process output (order-independent multiset
sha256 — the threaded reference's output order is nondeterministic, so
record identity is the meaningful contract), plus psum-reduced global
STAT equality. Records per-host throughput and scaling efficiency to
build/scale.json.

Each process is pinned to cpus/N OpenMP threads so "N hosts" split this
machine's cores fairly; efficiency is aggregate 2-proc rate over 2x the
1-proc rate.

Usage: python scale_run.py [--pairs 10000000] [--procs 2]
                           [--out build/scale.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")

_WORKER = r"""
import json, os, sys, time
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out_dir = sys.argv[4]
inputs = [tuple(p) for p in json.loads(sys.argv[5])]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
if nproc > 1:
    jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                               num_processes=nproc, process_id=pid)
sys.path.insert(0, os.environ["PSQ_ROOT"])
from pandaseq_tpu.parallel import distributed as D
perf = {}
vec, hist = D.run_distributed(inputs, out_dir=out_dir, batch=16384,
                              perf_out=perf)
print("RESULT " + json.dumps({
    "pid": pid, "vec": [int(x) for x in vec],
    "hist_sum": int(sum(hist.values())), "perf": perf}), flush=True)
"""


def ensure_data(pairs: int, shards: int):
    """``shards`` file pairs of pairs/shards each (the striped
    data-parallel layout: host h owns stripe h). Returns the list of
    (fwd, rev) path tuples."""
    per = pairs // shards
    out = []
    for s in range(shards):
        prefix = os.path.join(
            DATA, "scale%dk_s%d" % (per // 1000, s))
        f1 = prefix + "_1.fastq"
        if not os.path.exists(f1) or os.path.getsize(f1) < per * 600:
            print("generating stripe %d: %d pairs 2x300 (one-time)..."
                  % (s, per), flush=True)
            subprocess.run(
                [sys.executable, os.path.join(ROOT, "tests", "golden",
                                              "make_data.py"),
                 "--fast", "--pairs", str(per), "--read-len", "300",
                 "--amp-min", "420", "--amp-max", "560",
                 "--seed", str(11 + 7919 * s),
                 "--out-prefix", prefix], check=True)
        out.append((f1, prefix + "_2.fastq"))
    return out


def multiset_sha(paths) -> tuple[str, int]:
    """Order-independent record digest over FASTA part files: sha1 per
    record, sorted, sha256 over the concatenation. Returns (hexdigest,
    n_records)."""
    digests = []
    for path in paths:
        with open(path, "rb") as fh:
            rec = []
            for line in fh:
                if line.startswith(b">") and rec:
                    digests.append(hashlib.sha1(b"".join(rec)).digest())
                    rec = []
                rec.append(line)
            if rec:
                digests.append(hashlib.sha1(b"".join(rec)).digest())
    digests.sort()
    h = hashlib.sha256()
    for d in digests:
        h.update(d)
    return h.hexdigest(), len(digests)


def run_procs(nproc: int, inputs, out_dir: str, omp: int):
    """Each simulated host is PINNED (taskset) to its own disjoint
    ``omp``-core slice — including the 1-proc baseline. Without
    pinning, the baseline's pipeline threads (decode OMP pool +
    finalize OMP pool + python stages run CONCURRENTLY) spill across
    the whole machine despite OMP_NUM_THREADS, so "N hosts on one box"
    could never reach their aggregate and the efficiency ratio
    understated true multi-host scaling. With pinning, every simulated
    host sees the same fixed-size machine, which is what a real
    1-vs-N-host comparison measures."""
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = os.path.join(out_dir, "worker.py")
    with open(script, "w") as fh:
        fh.write(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PSQ_ROOT"] = ROOT
    env["OMP_NUM_THREADS"] = str(omp)

    import shutil
    have_taskset = shutil.which("taskset") is not None
    if not have_taskset:
        print("WARNING: taskset not found — hosts run UNPINNED and the "
              "efficiency ratio will understate true multi-host "
              "scaling", flush=True)

    def pin(i):
        cores = "%d-%d" % (i * omp, (i + 1) * omp - 1)
        return ["taskset", "-c", cores] if have_taskset else []

    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        pin(i) + [sys.executable, script, str(i), str(nproc), port,
                  out_dir, json.dumps([list(p) for p in inputs])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=ROOT) for i in range(nproc)]
    outs = [p.communicate()[0].decode() for p in procs]
    wall = time.perf_counter() - t0
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError("worker failed:\n" + o[-4000:])
    results = [json.loads(o.rsplit("RESULT ", 1)[1].splitlines()[0])
               for o in outs]
    parts = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                   if f.startswith("part-"))
    return results, parts, wall


def run_mode(tag, inputs, procs, omp, workdir):
    """One 1-proc vs N-proc comparison over the given input pairs."""
    print("=== %s: single process (OMP=%d) ===" % (tag, omp), flush=True)
    res1, parts1, _ = run_procs(1, inputs,
                                os.path.join(workdir, tag + "_single"),
                                omp)
    rate1 = res1[0]["perf"]["pairs_per_sec"]
    n_pairs = res1[0]["perf"]["pairs"]
    print("1-proc: %.0f pairs/s" % rate1, flush=True)
    print("=== %s: %d processes (OMP=%d each) ===" % (tag, procs, omp),
          flush=True)
    resN, partsN, _ = run_procs(procs, inputs,
                                os.path.join(workdir, tag + "_multi"),
                                omp)
    agg_rate = n_pairs / max(r["perf"]["wall_s"] for r in resN)
    print("%d-proc: aggregate %.0f pairs/s" % (procs, agg_rate),
          flush=True)
    sha1x, n1 = multiset_sha(parts1)
    shaNx, nN = multiset_sha(partsN)
    vec_equal = res1[0]["vec"] == resN[0]["vec"] and all(
        r["vec"] == resN[0]["vec"] for r in resN)
    return {
        "pairs": n_pairs,
        "procs": procs,
        "omp_threads_per_proc": omp,
        "single_pairs_per_sec": round(rate1, 1),
        "single_wall_s": round(res1[0]["perf"]["wall_s"], 2),
        "multi_aggregate_pairs_per_sec": round(agg_rate, 1),
        "multi_per_host_pairs_per_sec": [
            round(r["perf"]["pairs_per_sec"], 1) for r in resN],
        "multi_wall_s": [round(r["perf"]["wall_s"], 2) for r in resN],
        "scaling_efficiency": round(agg_rate / (procs * rate1), 4),
        "output_records_single": n1,
        "output_records_multi": nN,
        "multiset_sha256_single": sha1x,
        "multiset_sha256_multi": shaNx,
        "output_identical": sha1x == shaNx and n1 == nN,
        "global_stat_identical": vec_equal,
        "counters_vec": res1[0]["vec"],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10_000_000)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "scale.json"))
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build",
                                                      "psq_scale"))
    ap.add_argument("--skip-mux", action="store_true",
                    help="striped mode only")
    ap.add_argument("--mode", choices=["both", "striped", "mux"],
                    default="both",
                    help="rerun one mode, merging into an existing "
                         "--out artifact")
    args = ap.parse_args()

    inputs = ensure_data(args.pairs, args.procs)
    cpus = os.cpu_count() or 4
    omp = max(1, cpus // args.procs)

    out = {
        "config": "BASELINE config 5: %dM-pair synthetic MiSeq 2x300, "
                  "%d hosts (virtual CPU mesh, jax.distributed/Gloo)"
                  % (args.pairs // 1_000_000, args.procs),
    }
    if os.path.exists(args.out):
        try:
            with open(args.out) as fh:
                out.update(json.load(fh))
        except Exception:
            pass
    # striped = the data-parallel layout (one input stripe per host);
    # mux = one SHARED stream, round-robin batch claims (mux.c:132-161)
    # — every host decodes the full stream, so its scaling ceiling is
    # lower by construction
    if args.mode in ("both", "striped"):
        out["striped"] = run_mode("striped", inputs, args.procs, omp,
                                  args.workdir)
    if args.mode in ("both", "mux") and not args.skip_mux:
        out["mux_shared_stream"] = run_mode("mux", inputs[:1], args.procs,
                                            omp, args.workdir)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    ok = all(m["output_identical"] and m["global_stat_identical"]
             for m in out.values() if isinstance(m, dict))
    s = out.get("striped") or out["mux_shared_stream"]
    print(json.dumps({
        "single_pairs_per_sec": s["single_pairs_per_sec"],
        "multi_aggregate_pairs_per_sec":
            s["multi_aggregate_pairs_per_sec"],
        "scaling_efficiency": s["scaling_efficiency"],
        "all_identical": ok}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
