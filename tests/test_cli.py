"""The CLI's persistent compile cache: `JAX_COMPILATION_CACHE_DIR` when
set, else the fixed `<checkout>/.jax_cache`."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from geneevolve_tpu import cli

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env", [None, "/x/cache"])
def test_cache_dir_env_or_checkout(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cli.compilation_cache_dir() == str(REPO / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert cli.compilation_cache_dir() == env


def test_enable_defaults_inside_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("GE_NO_COMPILE_CACHE", raising=False)
    cli._enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")


def test_enable_sets_no_dir_when_env_given(monkeypatch, restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", "/unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x/cache")
    monkeypatch.delenv("GE_NO_COMPILE_CACHE", raising=False)
    cli._enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == "/unchanged"


def test_cache_written_to_env_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR writes its compiled
    programs there."""
    cache = tmp_path / "x"
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from geneevolve_tpu.cli import _enable_compilation_cache\n"
        "_enable_compilation_cache()\n"
        "import jax, jax.numpy as jnp\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((32, 32))).block_until_ready()\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(cache)}
    env.pop("GE_NO_COMPILE_CACHE", None)
    subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                   check=True, timeout=120)
    assert any(p.name.startswith("jit_") for p in cache.iterdir())
