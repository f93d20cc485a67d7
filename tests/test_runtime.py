"""Process-level set-up: the persistent compile cache location, and the GPU
smoke script refusing to run (and to print a result) without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from kgat_tpu.utils import cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(monkeypatch, restore_cache_dir, tmp_path,
                           env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache is runs/jaxcache under the repository root, whatever the
    working directory."""
    monkeypatch.chdir(tmp_path)
    jax.config.update("jax_compilation_cache_dir", None)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(_REPO, "runs", "jaxcache")
        assert cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On a CPU device (and in a directory holding nothing of the repo but
    the script) chip_smoke.py exits nonzero and prints no JSON result."""
    script = os.path.join(_REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path)
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
