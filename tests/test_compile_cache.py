"""Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
when set (JAX reads it; the package sets nothing), else one fixed
directory inside the checkout (the path is part of the cache key, so a
moving directory would never hit)."""

import os
import pathlib
import subprocess
import sys

import mathmap_tpu

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_env_var_wins_and_package_sets_nothing():
    assert mathmap_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None


def test_default_is_fixed_in_checkout_path():
    d = mathmap_tpu.compile_cache_dir({})
    assert d == str(ROOT / ".jax_cache")
    assert mathmap_tpu.compile_cache_dir({}) == d  # stable across calls


def test_gitignore_lists_the_cache():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def _cache_dir_after_import(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, mathmap_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_import_configures_jax(tmp_path):
    assert _cache_dir_after_import({}) == str(ROOT / ".jax_cache")
    other = str(tmp_path / "cache")
    assert _cache_dir_after_import(
        {"JAX_COMPILATION_CACHE_DIR": other}) == other
