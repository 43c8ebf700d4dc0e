"""The capability table, the -D platform flag and the compile cache."""

import os
import subprocess
import sys
from pathlib import Path

import jax

from hypergen_tpu.backend import Caps, caps
from hypergen_tpu.utils import jaxcache

REPO = Path(__file__).resolve().parents[1]


def test_caps_on_cpu():
    assert caps() == Caps(hash_path="xla", dot_mode=False, interpret=True)


def test_gpu_flag_without_gpu_exits_nonzero(tmp_path):
    (tmp_path / "g.fna").write_bytes(b">g\n" + b"ACGT" * 100 + b"\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "hypergen_tpu.cli", "sketch",
         "-p", str(tmp_path), "-o", str(tmp_path / "x.sketch"), "-D", "gpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode != 0
    assert "-D gpu" in r.stderr + r.stdout
    assert not (tmp_path / "x.sketch").exists()


def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    jaxcache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxcache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
