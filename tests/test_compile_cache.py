"""The persistent compilation cache helper: JAX_COMPILATION_CACHE_DIR
wins, otherwise a fixed directory inside the checkout."""

import os
import tempfile

import jax
import pytest

from folve_tpu.utils import compile_cache


@pytest.fixture
def updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_env_set_sets_nothing(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert updates == []


def test_env_unset_uses_checkout_dir(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]


def test_never_a_temp_path(monkeypatch, updates, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tempfile.tempdir = None  # re-read TMPDIR
    try:
        path = compile_cache.configure_compile_cache()
        assert tempfile.gettempdir() == str(tmp_path)
    finally:
        tempfile.tempdir = None
    assert path == os.path.join(compile_cache.CHECKOUT_DIR, ".jax_cache")
    assert not path.startswith(str(tmp_path))
