"""The one compile-cache helper: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise <checkout>/.jax_cache, a fixed path.  Every entry script uses
the helper and sets no cache directory of its own."""

import os
import subprocess
import sys

import pytest

import jax

from libmultiviewnative_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax; "
    "from libmultiviewnative_jax.utils.compile_cache import enable_compile_cache; "
    "print(enable_compile_cache()); "
    "print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout.split()


def test_unset_variable_uses_checkout_cache():
    returned, configured = _probe(None)
    want = os.path.join(REPO, ".jax_cache")
    assert returned == want and configured == want


def test_set_variable_is_left_to_jax(tmp_path):
    returned, configured = _probe(str(tmp_path))
    assert returned == str(tmp_path) and configured == str(tmp_path)


def test_set_variable_changes_no_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_checkout_is_the_repository_root():
    assert os.path.samefile(compile_cache.CHECKOUT, REPO)


@pytest.mark.parametrize("script", [
    "bench.py", "chip_smoke.py", "benchmarks/common.py",
    "scripts/stability_table.py",
])
def test_entry_scripts_use_the_helper(script):
    src = open(os.path.join(REPO, script)).read()
    assert "enable_compile_cache()" in src
    assert "jax_compilation_cache_dir" not in src
    assert "JAX_CACHE_DIR" not in src
