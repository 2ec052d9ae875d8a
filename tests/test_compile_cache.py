"""The persistent compile cache goes where JAX_COMPILATION_CACHE_DIR says,
else to the fixed path <root>/.jax_cache."""

import os

import jax
import pytest

from xcube_resampling_tpu.compile_cache import use_compile_cache


@pytest.fixture
def cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_dir_from_environment_is_left_alone(
    cache_config, monkeypatch, tmp_path
):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert use_compile_cache(tmp_path / "repo") == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_fixed_checkout_path(
    cache_config, monkeypatch, tmp_path
):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(str(tmp_path), ".jax_cache")
    assert use_compile_cache(tmp_path) == want
    assert jax.config.jax_compilation_cache_dir == want
