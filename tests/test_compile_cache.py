"""The persistent compile cache helper used by the benches and
chip_smoke.py."""

import jax

from lteax.utils import compile_cache


def test_env_var_set_leaves_jax_config_alone(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_inside_the_checkout(monkeypatch):
    import os
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(compile_cache.__file__))))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
