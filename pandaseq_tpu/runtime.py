"""Runtime knobs: persistent compilation cache, profiling and the
candidate-search engine choice."""

from __future__ import annotations

import os

# the repository checkout: caches live inside it, at fixed paths (the
# compile cache's directory is part of its key, so a moving path never
# hits)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


class maybe_profile:
    """jax.profiler trace over a run when PANDASEQ_TPU_PROFILE=<dir> is
    set (the framework's tracing story — SURVEY.md §5; the reference has
    only debug-flag logging)."""

    def __init__(self, trace_dir: str | None = None):
        self.dir = trace_dir or os.environ.get("PANDASEQ_TPU_PROFILE")
        self.active = False

    def __enter__(self):
        if self.dir:
            try:
                import jax
                jax.profiler.start_trace(self.dir)
                self.active = True
            except Exception:
                pass
        return self

    def __exit__(self, *exc):
        if self.active:
            try:
                import jax
                jax.profiler.stop_trace()
            except Exception:
                pass
        return False


def _probe_batch(B: int, L: int):
    """Synthetic reversed-frame Batch of ~250 bp ACGT pairs for the
    engine probe (deterministic; no N bases, so pack4 flags no rows)."""
    import numpy as np

    from .assembler import Batch
    rng = np.random.default_rng(7)
    codes = np.array([1, 2, 4, 8], dtype=np.int8)  # A C G T one-hot
    fwd = codes[rng.integers(0, 4, size=(B, L))]
    rev = codes[rng.integers(0, 4, size=(B, L))]
    lens = rng.integers(240, 251, size=B).astype(np.int32)
    pos = np.arange(L)[None, :]
    fwd[pos >= lens[:, None]] = 0
    rev[pos >= lens[:, None]] = 0
    q = np.full((B, L), 30, dtype=np.int8)
    return Batch([None] * B, fwd, q, rev, q, lens, lens.copy(), None)


def _probe_key(L, O, num_kmers):
    import multiprocessing
    import platform

    import jax
    dev = jax.devices()[0]
    return "%s:%s:%s:%d:L%d:O%d:k%d" % (
        jax.default_backend(), getattr(dev, "device_kind", "?"),
        platform.node(), multiprocessing.cpu_count(), L, O, num_kmers)


def pick_engine(L: int = 256, O: int = 256, num_kmers: int = 2,
                B: int = 4096, refresh: bool = False):
    """Measured auto-selection between the device candidate kernel and
    the native host twin (the production default must never lose to
    its own fallback on a given deployment).

    Returns (engine, info): engine in {"device", "host"}. The decision
    is a per-(backend, device kind, host, cores) probe — one warm device
    dispatch+fetch of the production candidate kernel vs the native
    psq_cand_mask twin on the same synthetic batch — cached in the
    checkout's .jax_cache/ (PANDASEQ_TPU_CACHE overrides) so the device
    compile cost is paid at most once per environment. Shortcuts: a cpu
    XLA backend always picks host (the twin is ~40x faster than CPU XLA
    — measured, r2); a missing native library always picks the device
    (there is no host twin). PANDASEQ_TPU_ENGINE=device|host pins
    without probing."""
    import json
    import time

    env = os.environ.get("PANDASEQ_TPU_ENGINE", "")
    if env in ("device", "host"):
        return env, {"reason": "env"}
    from .io import native
    if native.get_lib() is None:
        return "device", {"reason": "no-native"}
    import jax
    if jax.default_backend() == "cpu":
        return "host", {"reason": "cpu-backend"}

    key = _probe_key(L, O, num_kmers)
    cache_dir = os.environ.get("PANDASEQ_TPU_CACHE") or CACHE_DIR
    cache = os.path.join(cache_dir, "engine_probe.json")

    def read_cached():
        try:
            with open(cache) as fh:
                return json.load(fh)
        except Exception:
            return {}

    data = read_cached()
    if not refresh and key in data:
        return data[key]["engine"], data[key]

    # serialize concurrent probes across processes: a second process
    # starting its own device probe would contend for the device; it
    # should instead wait and read the first probe's cached verdict
    os.makedirs(cache_dir, exist_ok=True)
    lock_fh = open(os.path.join(cache_dir, "engine_probe.lock"), "a+")
    try:
        try:
            import fcntl
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
        except Exception:
            pass
        data = read_cached()  # another process may have probed first
        if not refresh and key in data:
            return data[key]["engine"], data[key]

        import sys
        print("pandaseq_tpu: probing candidate-search engines for this "
              "environment (one-time; pin with "
              "PANDASEQ_TPU_ENGINE=device|host to skip)",
              file=sys.stderr, flush=True)

        import numpy as np
        batch = _probe_batch(B, L)
        rows = np.arange(B, dtype=np.int64)
        k = max(num_kmers, 1)

        def best_of(fn, n=3):
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return min(ts)

        t_host = best_of(lambda: native.cand_mask(batch, rows, k, O))

        from .ops import fused2
        plane, _ = native.pack4(batch, L)
        run = lambda: np.asarray(
            fused2.assemble_candidates_list_packed4(
                plane, batch.flen, batch.rlen, L=L, O=O, num_kmers=k))
        run()  # compile + warm, once per environment
        t_dev = best_of(run)

        info = {"engine": "host" if t_host < t_dev else "device",
                "host_ms": round(t_host * 1e3, 2),
                "device_ms": round(t_dev * 1e3, 2),
                "B": B, "reason": "probe"}
        data[key] = info
        try:
            tmp = cache + ".%d.tmp" % os.getpid()
            with open(tmp, "w") as fh:
                json.dump(data, fh, indent=1)
            os.replace(tmp, cache)
        except Exception:
            pass
        return info["engine"], info
    finally:
        lock_fh.close()  # releases the flock


def enable_compilation_cache():
    """Turn on JAX's persistent compilation cache. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache there
    and no other directory is set here; otherwise the cache lives at the
    checkout's fixed .jax_cache/. Returns the directory in use."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
