"""utils/compile_cache.py: the persistent cache engages on this backend,
writes entries, and lives where JAX_COMPILATION_CACHE_DIR says or at one
fixed directory inside the checkout."""

import glob
import os
import tempfile

import pytest

from ohm_tsd_slam.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh_cache(monkeypatch):
    """Reset JAX's once-only cache init around a test, restoring the
    suite-wide cache afterwards."""
    import jax._src.compilation_cache as cc

    cc.reset_cache()
    yield monkeypatch
    monkeypatch.undo()
    cc.reset_cache()
    compile_cache.enable_persistent_cache(min_compile_secs=1.0)


def test_enable_persistent_cache_writes_entries(fresh_cache):
    import jax
    import jax.numpy as jnp

    with tempfile.TemporaryDirectory() as d:
        fresh_cache.setenv(compile_cache.ENV_VAR, d)
        assert compile_cache.enable_persistent_cache(
            min_compile_secs=0.0) == d

        @jax.jit
        def f(x):
            return jnp.tanh(x) @ x.T

        jax.block_until_ready(f(jnp.ones((64, 64))))
        assert glob.glob(os.path.join(d, "*")), "no cache entries written"


@pytest.mark.parametrize("env", ["/some/where/xla", None])
def test_cache_dir_placement(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env)
        want = env
    first = compile_cache.cache_dir()
    assert first == want
    # fixed: the same path on every call, never a per-process name
    assert compile_cache.cache_dir() == first


def test_enable_uses_env_dir_and_sets_jax_config(fresh_cache):
    import jax

    with tempfile.TemporaryDirectory() as d:
        fresh_cache.setenv(compile_cache.ENV_VAR, d)
        assert compile_cache.enable_persistent_cache() == d
        assert jax.config.jax_compilation_cache_dir == d


def test_default_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert os.path.basename(compile_cache.DEFAULT_DIR) in ignored
