"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when the
environment sets it (and no other directory set in code), else the
checkout's fixed .jax_cache/ (a moving directory never hits). Each case
runs in a child, because the setting is process-global."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax; from pandaseq_tpu.runtime import "
          "enable_compilation_cache as e; d = e(); "
          "print(d); print(jax.config.jax_compilation_cache_dir)")


def _probe(**env_over):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_over, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_cache_honours_env_dir(tmp_path):
    want = str(tmp_path / "jaxcache")
    used, config = _probe(JAX_COMPILATION_CACHE_DIR=want)
    assert used == want and config == want


def test_cache_defaults_to_checkout():
    used, config = _probe()
    want = os.path.join(ROOT, ".jax_cache")
    assert used == want and config == want
    assert os.path.isdir(want)
