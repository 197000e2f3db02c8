"""bench.py robustness: a driver kill at ANY point must leave a
parseable final-format JSON record in the stdout tail (an earlier
bench printed its only JSON line at the very end, so a timeout left
nothing to parse)."""

import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV = dict(
    os.environ, BENCH_FORCE_CPU="1", JAX_PLATFORMS="cpu",
    BENCH_BATCH="256", BENCH_PAIRS="1024", BENCH_BUDGET_S="5",
    BENCH_MIN_WINDOWS="1", BENCH_WINDOW_GAP_S="1",
    BENCH_DEADLINE_S="240")


def _parse_lines(raw):
    out = []
    for ln in raw.decode(errors="replace").splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            out.append(json.loads(ln))
    return out


def test_bench_emits_parseable_json_when_killed():
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    # the provisional record prints immediately; give it a moment, then
    # SIGTERM mid-run (the driver's timeout sends exactly this)
    first = proc.stdout.readline()
    time.sleep(2)
    proc.send_signal(signal.SIGTERM)
    try:
        rest, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        rest, _ = proc.communicate()
    recs = _parse_lines(first + rest)
    assert recs, "no JSON lines on stdout"
    last = recs[-1]
    assert last["metric"] == "read_pairs_per_sec"
    assert last["unit"] == "pairs/s"
    assert "vs_baseline" in last and "configs" in last
    # the SIGTERM handler marks the flushed record final
    assert last["final"] is True
    assert proc.returncode == 0


def test_bench_first_line_is_complete_schema():
    """Even the provisional first line carries the full schema, so a
    driver that parses ANY line (first, last, or all) gets the same
    shape."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    first = proc.stdout.readline()
    proc.kill()
    proc.wait()
    rec = json.loads(first)
    for key in ("metric", "value", "unit", "vs_baseline", "configs",
                "kernel_compute_ms", "error", "final"):
        assert key in rec
    assert rec["final"] is False
