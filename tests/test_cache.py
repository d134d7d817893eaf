"""Compile-cache location (utils/cache.py): JAX_COMPILATION_CACHE_DIR when
set (and nothing configured in code), else one fixed path inside the
checkout. jax.config.update is recorded, never applied, so the suite's
process keeps its cache off."""
import os

import pytest

import pycmf_tpu.utils.cache as cache


@pytest.fixture
def updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    return calls


@pytest.mark.parametrize("path", ["/somewhere/xla-cache", "rel/cache"])
def test_env_var_is_honoured(monkeypatch, updates, path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
    assert cache.enable_persistent_cache() == path
    assert updates == []


def test_fixed_path_same_across_calls(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = cache.enable_persistent_cache()
    second = cache.enable_persistent_cache()
    assert first == second == cache.CACHE_DIR
    assert ("jax_compilation_cache_dir", cache.CACHE_DIR) in updates


def test_fixed_path_ignores_cwd_and_home(monkeypatch, updates, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    here = cache.enable_persistent_cache()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert cache.enable_persistent_cache() == here


def test_fixed_path_is_inside_the_checkout_and_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(cache.CACHE_DIR) == repo
    with open(os.path.join(repo, ".gitignore")) as f:
        ignored = [ln.strip().rstrip("/") for ln in f]
    assert os.path.basename(cache.CACHE_DIR) in ignored
