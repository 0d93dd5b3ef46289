"""Compilation-cache location: JAX_COMPILATION_CACHE_DIR when set, else one
fixed directory inside the checkout that git ignores."""

import os
import subprocess
import sys
from pathlib import Path

from rawhash_tpu.utils.xla_cache import REPO_CACHE_DIR, cache_dir

REPO = Path(__file__).resolve().parent.parent
PROBE = (
    "import jax\n"
    "from rawhash_tpu.utils.xla_cache import enable_compile_cache\n"
    "d = enable_compile_cache()\n"
    "print(d, jax.config.jax_compilation_cache_dir)\n"
)


def _probe(**env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **env_extra)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, cwd=str(REPO),
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.split()


def test_env_var_names_the_cache(tmp_path):
    d = str(tmp_path / "xla")
    assert _probe(JAX_COMPILATION_CACHE_DIR=d) == [d, d]


def test_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert Path(cache_dir()) == REPO_CACHE_DIR == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_default_is_stable_across_processes(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    first = _probe(TMPDIR=str(tmp_path / "a"))
    second = _probe(TMPDIR=str(tmp_path / "b"))
    assert first == second == [str(REPO_CACHE_DIR)] * 2
