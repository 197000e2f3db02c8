"""Benchmark: read-pairs merged per second, device pipeline vs the C reference.

Prints final-format JSON lines to stdout:
  {"metric": "read_pairs_per_sec", "value": N, "unit": "pairs/s",
   "vs_baseline": R, ..., "final": true|false}

Robustness contract: a complete, parseable,
final-format line is printed IMMEDIATELY at startup and re-printed
(best-so-far) after every measurement milestone and window, so a driver
kill at ANY point — SIGTERM, SIGKILL, timeout — leaves a valid record
as the last JSON line in the tail. SIGTERM/SIGINT additionally flush a
final line before exiting 0. The script never exits non-zero.

Measurement order is capability-first: the device-resident kernel
K-slope (the chip-capability number) is measured BEFORE any e2e
windows, so even a 5-minute run records it. The device side runs in a
child subprocess (fresh process per attempt) with heartbeat monitoring
and retry/backoff. The parent never imports jax, and a retry starts only
after the previous child has been reaped, so one process at a time holds
the card.

Reported metric groups:
  - value / configs: e2e pairs/s per benchmark config (BASELINE.md).
    The headline config runs the ENGINE AUTO default (the measured
    device-vs-host pick a deployment actually serves, runtime.py);
    `simple_bayes_device` pins the device path for the accelerator
    record.
  - device_step_ms: serially-timed fused dispatch (upload + compute +
    download) — transport-inclusive.
  - kernel_*: device-resident compute of the production candidate
    kernel (lax.fori_loop over a 2-way dynamic_slice input so XLA
    cannot hoist the body; K=1 vs K=65 interleaved slope, fetch-timed).
    kernel_stage_ms splits frames+rank / candidate matmul / list-pack.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
REF_BIN = os.path.join(ROOT, "tests", "ref_build", "pandaseq-ref")
BATCH = int(os.environ.get("BENCH_BATCH", "16384"))
# exact multiple of BATCH so no partial-batch shape compiles mid-timing
N_PAIRS = int(os.environ.get("BENCH_PAIRS", str(BATCH * 12)))
DEPTH = int(os.environ.get("BENCH_DEPTH", "14"))
GROUP = int(os.environ.get("BENCH_GROUP", "4"))
# adaptive brownout abort: a config running > ABORT_X times its
# best-so-far wall time is a stalled window — kill the window
ABORT_X = float(os.environ.get("BENCH_ABORT_X", "3.0"))
# sampling budget for the timed windows: fits a defensive ~1200 s total
# deadline with warmup + capability phase, and incremental emission
# makes any overrun harmless anyway.
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "420"))
WINDOW_GAP_S = float(os.environ.get("BENCH_WINDOW_GAP_S", "15"))
MIN_WINDOWS = int(os.environ.get("BENCH_MIN_WINDOWS", "6"))
# parent-side deadline: assume a kill at ~1200 s unless told otherwise
DEADLINE_S = float(os.environ.get("BENCH_DEADLINE_S", "1140"))
# Watchdog budgets: heartbeats flow from a daemon thread, so a stale
# beat means the process is wedged — kill fast. The first device op
# includes compilation, so the pre-"kernel" budget is generous.
BEAT_STALE_S = float(os.environ.get("BENCH_BEAT_STALE_S", "90"))
FIRST_MILESTONE_S = float(os.environ.get("BENCH_FIRST_MILESTONE_S", "900"))
PROGRESS_S = float(os.environ.get("BENCH_PROGRESS_S", "300"))

FWD_PRIMER = "GTGCCAGCMGCCGCGGTAA"
REV_PRIMER = "GGACTACHVGGGTWTCTAAT"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def ensure_data(prefix, seed, extra=()):
    p1 = os.path.join(DATA, prefix + "_1.fastq")
    if not (os.path.exists(p1)
            and sum(1 for _ in open(p1)) == 4 * N_PAIRS):
        log(f"generating {N_PAIRS} pairs for {prefix} (one-time)...")
        subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests", "golden",
                                          "make_data.py"),
             "--pairs", str(N_PAIRS), "--seed", str(seed),
             "--out-prefix", os.path.join(DATA, prefix), *extra],
            check=True, cwd=ROOT, stdout=subprocess.DEVNULL)
    return p1, os.path.join(DATA, prefix + "_2.fastq")


def _data_files():
    # non-default sizes (smoke tests, experiments) get their own file
    # pairs so a small run never truncates the standard dataset out
    # from under a concurrent full run
    suf = "" if N_PAIRS == 196608 else "_%d" % N_PAIRS
    plain = ensure_data("bench" + suf, 7)
    primed = ensure_data("benchp" + suf, 23,
                         ("--fwd-primer", FWD_PRIMER,
                          "--rev-primer", REV_PRIMER))
    return plain, primed


# Benchmark configs (BASELINE.md:30-34). Each row: name, dataset
# ("plain"/"primed"/None = our-side only), reference CLI flags.
CONFIGS = [
    # headline: the ENGINE AUTO default (what a deployment serves)
    ("simple_bayes", "plain", []),
    # the same config pinned to the device path (accelerator record)
    ("simple_bayes_device", None, None),
    ("primers+filters", "primed",
     ["-p", FWD_PRIMER, "-q", REV_PRIMER, "-A", "rdp_mle",
      "-C", "min_overlapbits", "-C", "completely_miss_the_point:4"]),
    # reference side runs -A pear WITHOUT the pear_test plugin: the
    # combination hangs the reference binary (size_t underflow in
    # plugin_pear_test.c:33, see PARITY.md) — our side still runs the
    # full config, so this comparison slightly favors the reference
    ("pear+pear_test", "plain", ["-A", "pear"]),
    ("rdp_mle", "plain", ["-A", "rdp_mle"]),
    ("uparse", "plain", ["-A", "uparse"]),
    # dense scoring (-k 0: every overlap examined — the reference's own
    # SLOW path, assembler.c:42,118,135-137): the accelerator-vs-host
    # A/B, both sides in the SAME weather window
    ("dense_k0", "plain", ["-k", "0"]),
    ("dense_k0_host", None, None),
]

# which reference config each our-side row is compared against
REF_KEY = {"simple_bayes_device": "simple_bayes",
           "dense_k0_host": "dense_k0"}


def bench_reference(files, ref_out: dict, on_update=None) -> None:
    """C reference pairs/s (its default: one thread per CPU) for every
    benchmark config, written into ref_out as each lands. Never
    raises — runs on a background thread."""
    try:
        if not os.path.exists(REF_BIN):
            subprocess.run(["bash", os.path.join(ROOT, "tests", "golden",
                                                 "build_ref.sh")],
                           check=True, capture_output=True)
    except Exception as e:
        log(f"reference build failed: {e}")
        return
    plain, primed = files
    for name, ds, flags in CONFIGS:
        if ds is None:
            continue  # our-side-only rows
        f1, f2 = plain if ds == "plain" else primed
        try:
            best = None
            for _ in range(4 if name == "simple_bayes" else 2):
                t0 = time.perf_counter()
                with open(os.devnull, "wb") as devnull:
                    subprocess.run([REF_BIN, "-f", f1, "-r", f2, *flags],
                                   stdout=devnull,
                                   stderr=subprocess.DEVNULL, check=False,
                                   timeout=600)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            # max-merge: the first pass runs concurrently with the
            # device child's compile phase, so a later QUIET pass may
            # measure the reference faster — the reference is always
            # credited its best observed rate (fairness: vs_baseline
            # must not be inflated by host contention)
            rate = round(N_PAIRS / best, 1)
            with _EMIT_LOCK:  # build_out iterates ref_out concurrently
                ref_out[name] = max(ref_out.get(name, 0.0), rate)
            log(f"reference[{name}]: {N_PAIRS} pairs in {best:.2f}s = "
                f"{rate:.0f} pairs/s (best {ref_out[name]:.0f})")
            if on_update:
                on_update()
        except Exception as e:
            log(f"reference[{name}] failed: {e}")


# ---------------------------------------------------------------------------
# Device child
# ---------------------------------------------------------------------------

_WRITE_LOCK = None


def _write_json(path, obj):
    # the beat daemon and the main thread both write this file; an
    # unserialized shared tmp name raced (os.replace -> FileNotFound)
    # and killed a child mid-windows
    global _WRITE_LOCK
    if _WRITE_LOCK is None:
        _WRITE_LOCK = threading.Lock()
    with _WRITE_LOCK:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(obj, fh)
        os.replace(tmp, path)


def _child_configs(files):
    """Build (name, batches_fn, assembler_fn) rows for the child."""
    import numpy as np

    from pandaseq_tpu import filters, oracle, stats
    from pandaseq_tpu.assembler import BatchAssembler
    from pandaseq_tpu.io import native
    from pandaseq_tpu.nt import nt_from_ascii, nt_from_ascii_complement

    plain, primed = files
    logger = stats.LogProxy(open(os.devnull, "wb"))

    def reader(f1, f2):
        def batches():
            yield from native.NativeBatchReader(f1, f2, policy="PRESENT",
                                                batch=BATCH, L=512,
                                                ring=2 * DEPTH + GROUP
                                                + 14)
        return batches

    def mk(cfg=None, modules=(), host_only=False):
        # rows pin their engine explicitly: the auto probe must not
        # silently flip the accelerator measurements to the host path
        # (headline row excepted — measuring the auto default IS its
        # job)
        def make():
            return BatchAssembler(cfg or oracle.OracleConfig(), L=512,
                                  modules=list(modules),
                                  host_only=host_only)
        return make

    cfg2 = oracle.OracleConfig(
        algorithm=oracle.make_algorithm("rdp_mle"),
        forward_primer=nt_from_ascii(
            np.frombuffer(FWD_PRIMER.encode(), dtype=np.uint8)),
        reverse_primer=nt_from_ascii_complement(
            np.frombuffer(REV_PRIMER.encode(), dtype=np.uint8)))

    def mods2():
        return [filters.load_module("min_overlapbits", logger),
                filters.load_module("completely_miss_the_point:4", logger)]

    cfg3 = oracle.OracleConfig(algorithm=oracle.make_algorithm("pear"))

    def mods3():
        return [filters.load_module("pear_test", logger)]

    rows = [
        ("simple_bayes", reader(*plain), mk(host_only=None)),  # AUTO
        ("simple_bayes_device", reader(*plain), mk()),
        ("primers+filters", reader(*primed),
         lambda: BatchAssembler(cfg2, L=512, modules=mods2(),
                                host_only=False)),
        ("pear+pear_test", reader(*plain),
         lambda: BatchAssembler(cfg3, L=512, modules=mods3(),
                                host_only=False)),
        ("rdp_mle", reader(*plain),
         mk(oracle.OracleConfig(algorithm=oracle.make_algorithm(
             "rdp_mle")))),
        ("uparse", reader(*plain),
         mk(oracle.OracleConfig(algorithm=oracle.make_algorithm(
             "uparse")))),
        ("dense_k0", reader(*plain), mk(oracle.OracleConfig(num_kmers=0))),
        ("dense_k0_host", reader(*plain),
         mk(oracle.OracleConfig(num_kmers=0), host_only=True)),
    ]
    return rows


def _kslope_multi(fns, stacked, flen, rlen, reps=7, khi=65):
    """Device-resident compute ms/call for SEVERAL kernels measured in
    ONE interleaved sampling window: each fn gets a lax.fori_loop
    driver with a 2-way dynamic_slice input (XLA cannot hoist the
    body) at K=1 and K=khi, all 2*len(fns) programs sampled
    round-robin, slope = (min tK - min t1)/(khi-1), fetch-timed. One
    shared window keeps drift out of BOTH the slopes and the
    cross-stage differences. The wide K spread buries per-fetch jitter
    under 64 iterations of signal. fns: {name: (fn, out_shape, out_dtype)};
    returns {name: ms}."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    progs = {}
    for name, (fn, out_shape, out_dtype) in fns.items():
        for K in (1, khi):
            @jax.jit
            def f(stk, fl, rl, K=K, fn=fn, out_shape=out_shape,
                  out_dtype=out_dtype):
                def body(k, acc):
                    p = jax.lax.dynamic_slice_in_dim(
                        stk, k % 2, 1, axis=0)[0]
                    return jnp.bitwise_xor(acc, fn(p, fl, rl))
                z = jnp.zeros(out_shape, dtype=out_dtype)
                return jax.lax.fori_loop(0, K, body, z)
            np.asarray(f(stacked, flen, rlen))  # compile + warm
            progs[name, K] = f
    ts = {key: [] for key in progs}
    for _ in range(reps):
        for key, f in progs.items():
            t0 = time.perf_counter()
            np.asarray(f(stacked, flen, rlen))
            ts[key].append(time.perf_counter() - t0)
    return {name: max((min(ts[name, khi]) - min(ts[name, 1]))
                      / (khi - 1), 1e-6) * 1e3 for name in fns}


def _kslope(fn, stacked, flen, rlen, out_shape, out_dtype, reps=7,
            khi=65):
    """Single-kernel convenience wrapper over _kslope_multi."""
    return _kslope_multi({"k": (fn, out_shape, out_dtype)}, stacked,
                         flen, rlen, reps=reps, khi=khi)["k"]


def kernel_capability(st, state, beat):
    """Device-resident capability of the PRODUCTION candidate kernel,
    with a stage split. Writes kernel_* fields into
    state as each lands. st must carry _kernel_inputs and num_kmers."""
    import jax.numpy as jnp
    import numpy as np

    from pandaseq_tpu.ops import fused2

    plane4, flen, rlen = st["_kernel_inputs"]
    L, O, nk = st["Lb"], st["O"], st["num_kmers"]
    B = plane4.shape[0]
    stacked = np.stack([plane4, np.roll(plane4, 1, axis=0)])
    # CPU smoke runs can't afford 65 iterations of the kernel per
    # sample; the device default needs them for a jitter-proof slope
    khi = int(os.environ.get(
        "BENCH_KSLOPE_KHI",
        "9" if os.environ.get("BENCH_FORCE_CPU") else "65"))

    import jax

    # full production kernel (candidate LIST download variant)
    def full(p, fl, rl):
        return fused2.assemble_candidates_list_packed4(
            p, fl, rl, L=L, O=O, num_kmers=nk)

    # stage partials: frames+rank | + candidate matmul. Each folds to
    # [B] via a POSITION-WEIGHTED matvec — tiny accumulator (a [B, L]
    # int32 acc measured ~40 ms of pure HBM traffic, swamping the
    # 0.5 ms stage), but still position-dependent so XLA cannot elide
    # the rank sorts (a plain sum is permutation-invariant).
    def fold(x):
        w = jnp.arange(1, x.shape[1] + 1, dtype=jnp.int32)
        return jax.lax.dot_general(
            x.astype(jnp.int32), w, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)

    def frames(p, fl, rl):
        from pandaseq_tpu.ops.fused2 import (_unpack2bit,
                                             kmer_frames_codes)
        cf, cr, nonn = _unpack2bit(p, L)
        Fkm, Rkm = kmer_frames_codes(cf, nonn, cr, nonn,
                                     fl.astype(jnp.int32),
                                     rl.astype(jnp.int32), L, nk)
        return fold(Fkm) ^ fold(Rkm)

    def cand(p, fl, rl):
        return fold(fused2._candc_packed4(p, fl, rl, L, O, nk))

    # all three measured in ONE interleaved window so the split is
    # internally consistent (separate phases minutes apart caught
    # different weather and made partials exceed the full kernel)
    ms = _kslope_multi(
        {"full": (full, (B, fused2.CAND_LIST_C + 2), jnp.int16),
         "frames": (frames, (B,), jnp.int32),
         "cand": (cand, (B,), jnp.int32)},
        stacked, flen, rlen, khi=khi)
    full_ms, f_ms, c_ms = ms["full"], ms["frames"], ms["cand"]
    state["kernel_compute_ms"] = round(full_ms, 2)
    state["kernel_pairs_per_sec"] = round(B / (full_ms * 1e-3), 0)
    state["kernel_B"], state["kernel_L"], state["kernel_O"] = B, L, O
    log(f"kernel: {full_ms:.2f} ms/{B}-pair batch device-resident = "
        f"{state['kernel_pairs_per_sec']:.0f} pairs/s/device")
    split = {"frames_rank": round(f_ms, 2),
             "candidate_matmul": round(max(c_ms - f_ms, 0.0), 2),
             "list_pack": round(max(full_ms - c_ms, 0.0), 2)}
    if not (f_ms <= c_ms * 1.25 and c_ms <= full_ms * 1.25):
        split["note"] = ("partials exceed the full kernel — timing "
                         "drifted within the window")
    state["kernel_stage_ms"] = split
    log(f"kernel stages: frames+rank {f_ms:.2f} ms, +candidate "
        f"{c_ms - f_ms:.2f} ms, +list-pack {full_ms - c_ms:.2f} ms")
    beat()
    return full_ms


def device_child(out_path):
    """Runs on the device; writes best-so-far results to out_path after
    every milestone so the parent keeps partial data if we die.
    Capability-first order: kernel K-slope before any e2e windows."""
    if os.environ.get("BENCH_SELFTEST_FAIL"):  # failure-path smoke test
        raise RuntimeError("selftest: simulated backend failure")
    if os.environ.get("BENCH_FORCE_CPU"):  # machinery smoke tests only
        import jax
        jax.config.update("jax_platforms", "cpu")
    from pandaseq_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    import numpy as np

    from pandaseq_tpu.io.prefetch import prefetch

    state = {"heartbeat": time.time()}
    _write_json(out_path, state)

    # liveness beats from a daemon thread: they keep flowing while the
    # main thread is blocked in a long compile or device op (which
    # releases the GIL), so the parent can tell "alive but slow" from
    # "wedged"
    def _beatloop():
        while True:
            time.sleep(10)
            state["heartbeat"] = time.time()
            try:
                _write_json(out_path, dict(state))
            except Exception:
                pass
    threading.Thread(target=_beatloop, daemon=True).start()

    files = _data_files()
    rows = _child_configs(files)

    def beat():
        state["heartbeat"] = time.time()
        _write_json(out_path, dict(state))

    # --- capability first: device-resident kernel K-slope (the
    # compile lands on its first dispatch; the capability number
    # survives even a short run) ---
    name0, batches0, mk0 = rows[0]
    dev_asm = rows[1][2]()  # the pinned-device assembler
    bt = next(iter(batches0()))
    st = dev_asm._pre(bt)
    st["num_kmers"] = dev_asm.cfg.num_kmers
    from pandaseq_tpu.io import native
    plane4, _hasN = native.pack4(st["batch"], st["Lb"])
    st["_kernel_inputs"] = (plane4, st["batch"].flen, st["batch"].rlen)
    state["phase"] = "kslope"
    beat()
    try:
        kernel_capability(st, state, beat)
    except Exception as e:
        log(f"K-slope measurement failed (non-fatal): {e!r}")
    state["initialized"] = True
    beat()

    # --- device step (transport-inclusive) ---
    state["phase"] = "device_step"
    beat()
    try:
        dev = dev_asm._dispatch(st)
        np.asarray(dev)
        ts = []
        for _ in range(5):
            t1 = time.perf_counter()
            np.asarray(dev_asm._dispatch(st))
            ts.append(time.perf_counter() - t1)
        B, O = st["B"], st["O"]
        state["device_step_ms"] = round(min(ts) * 1e3, 1)
        log(f"device step: {state['device_step_ms']} ms/batch incl "
            f"transport (B={B}, O={O})")
    except Exception as e:
        log(f"device step failed (non-fatal): {e!r}")
    beat()

    # --- headline engine resolution (the auto probe) + warm-up ---
    state["phase"] = "warmup"
    beat()
    asms = {}
    for name, batches, mkasm in rows:
        a = asms[name] = mkasm()
    try:
        state["engine"] = asms[name0].engine  # resolves the probe
        state["engine_info"] = dict(asms[name0].engine_info or {})
        log(f"headline engine (auto): {state['engine']} "
            f"({state['engine_info']})")
    except Exception as e:
        log(f"engine resolution failed (non-fatal): {e!r}")
    beat()
    for name, batches, _ in rows:
        state["phase"] = f"warm:{name}"
        beat()
        for _ in asms[name].emit_stream(batches(), depth=DEPTH,
                                        group=GROUP):
            break  # enough batches flow to compile the grouped bucket
        log(f"warmed {name}")
        beat()

    # --- timed windows: all configs sampled round-robin in the SAME
    # weather window; best per config across windows; brownout windows
    # aborted and not counted (bounded total attempts) ---
    best = {name: 0.0 for name, _, _ in rows}
    windows = 0
    windows_ok = 0
    end = time.perf_counter() + BUDGET_S
    while (windows_ok < MIN_WINDOWS or time.perf_counter() < end) \
            and windows < 6 * MIN_WINDOWS:
        windows += 1
        rot = windows % len(rows)
        aborted = False
        for name, batches, mkasm in rows[rot:] + rows[:rot]:
            a = mkasm()
            abort_at = None
            if ABORT_X > 0 and best[name] > 0:
                abort_at = ABORT_X * N_PAIRS / best[name] + 3.0
            t1 = time.perf_counter()
            n = 0
            for _, codes, payload in a.emit_stream(
                    prefetch(a.pre_stream(batches()), depth=DEPTH + 2),
                    depth=DEPTH, threaded=True, group=GROUP):
                n += len(codes)
                if abort_at is not None \
                        and time.perf_counter() - t1 > abort_at:
                    aborted = True
                    break
            dt = time.perf_counter() - t1
            if aborted:
                log(f"window {windows} {name}: brownout abort after "
                    f"{dt:.1f}s ({n} pairs) — window not counted")
                beat()
                break
            rate = n / dt
            best[name] = max(best[name], rate)
            if a._offload_count:
                state["offload_batches"] = (
                    state.get("offload_batches", 0) + a._offload_count)
                state["offload_timeouts"] = (
                    state.get("offload_timeouts", 0)
                    + a._offload_timeouts)
            log(f"window {windows} {name}: {n} pairs in {dt:.2f}s = "
                f"{rate:.0f} pairs/s (best {best[name]:.0f})")
            state["configs"] = {k: round(v, 1) for k, v in best.items()
                                if v}
            state["value"] = state["configs"].get("simple_bayes")
            state["windows"] = windows
            beat()
        if not aborted:
            windows_ok += 1
        if time.perf_counter() < end:
            time.sleep(WINDOW_GAP_S)
    # capability re-sample: the early measurement can land in a
    # throttled window (same-day spread 2x observed); keep the best
    try:
        prev = state.get("kernel_compute_ms", 1e9)
        saved = {k: state.get(k) for k in
                 ("kernel_compute_ms", "kernel_pairs_per_sec",
                  "kernel_stage_ms")}
        kernel_capability(st, state, beat)
        if state.get("kernel_compute_ms", 1e9) > prev:
            state.update({k: v for k, v in saved.items()
                          if v is not None})
    except Exception as e:
        log(f"K-slope re-measure failed (non-fatal): {e!r}")
    state["windows_ok"] = windows_ok
    state["done"] = True
    _write_json(out_path, state)
    log(f"child done: {windows} windows ({windows_ok} counted), "
        f"best {best}")


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------

STATE = {"ref": {}, "merged": {}, "error": None}
# RLock: the SIGTERM handler runs on the main thread and may interrupt
# an in-progress emit() — a plain Lock would self-deadlock there. Also
# held by merge() so build_out's dict iteration (ref thread) never
# races the main thread's config inserts.
_EMIT_LOCK = threading.RLock()
_LAST_LINE = [None]
_CHILD = None  # live device child, killed by the signal handler


def build_out(final: bool) -> dict:
    merged = STATE["merged"]
    ref = STATE["ref"]
    value = merged.get("value")
    configs = merged.get("configs", {})
    vs_cfg = {}
    for k, v in configs.items():
        rk = REF_KEY.get(k, k)
        if ref.get(rk):
            vs_cfg[k] = round(v / ref[rk], 3)
    ref_rate = ref.get("simple_bayes")
    out = {"metric": "read_pairs_per_sec",
           "value": round(value, 1) if value else None,
           "unit": "pairs/s",
           "vs_baseline": (round(value / ref_rate, 3)
                           if value and ref_rate else None),
           "engine": merged.get("engine"),
           "device_step_ms": merged.get("device_step_ms"),
           "kernel_compute_ms": merged.get("kernel_compute_ms"),
           "kernel_pairs_per_sec": merged.get("kernel_pairs_per_sec"),
           "kernel_stage_ms": merged.get("kernel_stage_ms"),
           "kernel_B": merged.get("kernel_B"),
           "kernel_O": merged.get("kernel_O"),
           "reference_pairs_per_sec": ref_rate,
           "configs": configs or None,
           "reference_configs": dict(ref) or None,
           "vs_baseline_configs": vs_cfg or None,
           "windows": merged.get("windows"),
           "offload_batches": merged.get("offload_batches"),
           "offload_timeouts": merged.get("offload_timeouts"),
           "error": merged.get("error") or STATE["error"],
           "final": final}
    cdense = configs.get("dense_k0")
    chost = configs.get("dense_k0_host")
    out["accel_vs_host_dense"] = (round(cdense / chost, 3)
                                  if cdense and chost else None)
    # wire self-diagnosis: the sparse headline ships 128 B/pair up
    # (2-bit codes) + 12 B/pair down (candidate list)
    cdev = configs.get("simple_bayes_device")
    out["wire_bytes_per_pair"] = 140
    out["effective_wire_MBps"] = (round(cdev * 140 / 1e6, 1)
                                  if cdev else None)
    return out


def emit(final: bool = False):
    """Print a complete final-format JSON line (best-so-far) to stdout.
    Deduplicates identical consecutive lines."""
    with _EMIT_LOCK:
        line = json.dumps(build_out(final))
        if line != _LAST_LINE[0]:
            _LAST_LINE[0] = line
            print(line, flush=True)


def run_child_attempts():
    """Launch device children with heartbeat watchdog + retry/backoff,
    merging best-so-far results into STATE['merged'] LIVE (and emitting
    a JSON line on every change)."""
    out_path = os.path.join(ROOT, ".bench_child.json")
    merged = STATE["merged"]
    global _CHILD
    deadline = time.monotonic() + DEADLINE_S
    backoff = 20.0
    attempt = 0

    def merge(data, done):
        # under _EMIT_LOCK: build_out (possibly on the ref thread via
        # on_update=emit) iterates these dicts while we insert
        with _EMIT_LOCK:
            return _merge_locked(data, done)

    def _merge_locked(data, done):
        changed = False
        for k, v in data.items():
            if k == "configs":
                m = merged.setdefault("configs", {})
                for ck, cv in v.items():
                    if cv > m.get(ck, 0.0):
                        m[ck] = cv
                        changed = True
            elif k == "value":
                if v and v > (merged.get("value") or 0):
                    merged["value"] = v
                    changed = True
            elif k in ("heartbeat", "phase"):
                pass
            elif done or k not in merged:
                if merged.get(k) != v:
                    merged[k] = v
                    changed = True
        if merged.get("configs"):
            v = max(merged["configs"].get("simple_bayes", 0) or 0,
                    merged.get("value") or 0) or None
            if v != merged.get("value"):
                merged["value"] = v
                changed = True
        return changed

    while time.monotonic() < deadline:
        attempt += 1
        try:
            os.unlink(out_path)
        except FileNotFoundError:
            pass
        log(f"--- device attempt {attempt} ---")
        # child stdout -> our stderr: our stdout carries ONLY the
        # final-format JSON lines
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--device-child", out_path], cwd=ROOT,
                                stdout=sys.stderr.fileno()
                                if hasattr(sys.stderr, "fileno") else None)
        _CHILD = proc
        start = time.monotonic()
        # adaptive first-milestone budget: never let one stalled
        # attempt eat the whole deadline — a retry needs runway
        first_budget = max(420.0, min(FIRST_MILESTONE_S,
                                      deadline - start - 360.0))
        last_beat_val, last_beat_t = None, start
        last_prog_sig, last_prog_t = None, start
        while True:
            rc = proc.poll()
            try:
                with open(out_path) as fh:
                    data = json.load(fh)
            except Exception:
                data = {}
            now = time.monotonic()
            if data.get("heartbeat") != last_beat_val:
                last_beat_val, last_beat_t = data.get("heartbeat"), now
            sig = json.dumps({k: v for k, v in data.items()
                              if k != "heartbeat"}, sort_keys=True)
            if sig != last_prog_sig:
                last_prog_sig, last_prog_t = sig, now
                if merge(data, data.get("done")):
                    emit()
            if rc is not None:
                break
            kill_why = None
            if last_beat_val is not None and \
                    now - last_beat_t > BEAT_STALE_S:
                kill_why = f"heartbeat stale {now - last_beat_t:.0f}s"
            elif not data.get("initialized") and \
                    now - start > first_budget:
                kill_why = f"no first milestone in {now - start:.0f}s"
            elif data.get("initialized") and \
                    now - last_prog_t > PROGRESS_S:
                kill_why = f"no progress for {now - last_prog_t:.0f}s"
            elif now > deadline + 60:
                kill_why = "past deadline"
            if kill_why:
                log(f"attempt {attempt}: {kill_why}, killing pid "
                    f"{proc.pid}")
                proc.kill()
                proc.wait()
                rc = -9
                break
            time.sleep(3)
        # final merge of whatever the child managed to record
        try:
            with open(out_path) as fh:
                data = json.load(fh)
        except Exception:
            data = {}
        if merge(data, data.get("done")):
            emit()
        if rc == 0 and data.get("done"):
            merged.pop("error", None)
            return
        merged["error"] = f"child attempt {attempt} rc={rc}"
        emit()
        log(f"attempt {attempt} failed (rc={rc}); retrying after "
            f"{backoff:.0f}s (deadline in "
            f"{deadline - time.monotonic():.0f}s)")
        if time.monotonic() + backoff >= deadline:
            break
        time.sleep(backoff)
        backoff = min(backoff * 2, 240)


def main():
    # SIGTERM/SIGINT (the driver's timeout kill) -> flush a final line
    # and exit 0: the record survives the kill
    def _die(signum, frame):
        STATE["error"] = STATE["error"] or f"killed by signal {signum}"
        try:  # reap the device child FIRST — even if emission fails,
            if _CHILD is not None and _CHILD.poll() is None:  # the
                _CHILD.kill()  # card must never be left held
                _CHILD.wait(timeout=30)
        except Exception:
            pass
        try:
            # direct fd write, not print(): the handler may have
            # interrupted an in-progress emit() mid-line, so start
            # with a newline and bypass the (re-entrant) lock/stdout
            # buffer entirely
            line = "\n" + json.dumps(build_out(True)) + "\n"
            os.write(1, line.encode())
        except Exception:
            pass
        os._exit(0)
    try:
        signal.signal(signal.SIGTERM, _die)
        signal.signal(signal.SIGINT, _die)
    except Exception:
        pass

    emit()  # provisional record: any kill from here on leaves a line
    try:
        files = _data_files()
    except Exception as e:
        log(f"data generation failed: {e}")
        STATE["error"] = f"data generation failed: {e}"
        emit(final=True)
        return
    # reference measurement on a background thread: the device child's
    # compile phase leaves the host cores mostly free
    ref_thread = threading.Thread(
        target=bench_reference, args=(files, STATE["ref"], emit),
        daemon=True)
    ref_thread.start()
    t_start = time.monotonic()
    try:
        run_child_attempts()
    except Exception as e:
        log(f"unexpected parent failure: {e!r}")
        STATE["error"] = f"parent: {e!r}"
    ref_thread.join(timeout=120)
    # quiet refinement pass: the first reference pass contended with
    # the device child's host stages; re-measure on the now-idle host and
    # keep each config's best (max-merge inside bench_reference)
    if time.monotonic() - t_start < DEADLINE_S:
        log("--- quiet reference refinement pass ---")
        bench_reference(files, STATE["ref"], emit)
    emit(final=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--device-child":
        try:
            device_child(sys.argv[2])
        except Exception:
            import traceback
            traceback.print_exc()
            sys.exit(1)
    else:
        main()
