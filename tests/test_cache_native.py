"""Compile-cache location and the hash-keyed native build."""

import ctypes
import os
import subprocess
import sys

import pytest

from smartdenovo_tpu.utils import cache, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    import jax

    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_cache_dir_honours_env(monkeypatch, tmp_path, restore_cache_config):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    assert cache.enable_compilation_cache() == str(tmp_path / "xla")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "xla")
    assert os.path.isdir(tmp_path / "xla")


def test_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_cache_dir_fixed_across_processes():
    """Neither the PID nor the clock enters the default path."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    code = ("import sys; sys.path.insert(0, %r); "
            "from smartdenovo_tpu.utils.cache import cache_dir; "
            "print(cache_dir())" % ROOT)
    outs = {subprocess.run([sys.executable, "-c", code], env=env, check=True,
                           capture_output=True, text=True).stdout.strip()
            for _ in range(2)}
    assert outs == {os.path.join(ROOT, ".jax_cache")}


SRC = 'extern "C" int answer() { return %d; }\n'


def test_lib_path_keyed_on_source(tmp_path):
    (tmp_path / "k.cpp").write_text(SRC % 1)
    a = native.lib_path("k", str(tmp_path))
    assert native.lib_path("k", str(tmp_path)) == a
    (tmp_path / "k.cpp").write_text(SRC % 2)
    b = native.lib_path("k", str(tmp_path))
    assert a != b and os.path.dirname(b) == str(tmp_path)


def test_build_follows_source(tmp_path):
    """An edited source builds (and loads) a new library; the stale one
    is never picked up."""
    (tmp_path / "k.cpp").write_text(SRC % 41)
    lib = native.build_and_load("k", str(tmp_path))
    assert lib.answer() == 41
    (tmp_path / "k.cpp").write_text(SRC % 42)
    native._CACHE.clear()
    lib2 = native.build_and_load("k", str(tmp_path))
    assert lib2.answer() == 42
    sos = sorted(p for p in os.listdir(tmp_path) if p.endswith(".so"))
    assert len(sos) == 2 and not any(p.endswith(".tmp")
                                     for p in os.listdir(tmp_path))
    assert isinstance(lib2, ctypes.CDLL)
