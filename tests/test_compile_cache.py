"""Where the persistent compilation cache lives."""

import pytest

from obvi_slam_tpu import compile_cache as cc


@pytest.mark.parametrize(
    "environ, expected",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/cache/here"}, "/cache/here"),
        ({}, str(cc.REPO_ROOT / ".jax_cache")),
        ({"JAX_COMPILATION_CACHE_DIR": ""}, str(cc.REPO_ROOT / ".jax_cache")),
    ],
)
def test_cache_dir(environ, expected):
    assert cc.cache_dir(environ) == expected


def test_cache_dir_reads_the_process_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cc.cache_dir() == str(cc.REPO_ROOT / ".jax_cache")
