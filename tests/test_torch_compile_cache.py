"""The port's kernel compile cache (``utils/compile_cache.py``), the
counterpart of ``tests/test_compile_cache.py``: the directory's
resolution, the CLI flag's, non-fatal failures on an uncreatable or
read-only directory, and a cache hit across processes.  On the CPU the hit
is shown with the host library ``libmmla_host.so`` (g++), so it needs no
``nvcc``: the second process finds the library in the cache and runs no
compiler (``_build.compiles``)."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mmla_audio_torch import _build, cli
from mmla_audio_torch.utils import compile_cache as cc

REPO = Path(__file__).resolve().parent.parent

_CHILD = r"""
import os
import sys

from mmla_audio_torch import _build
from mmla_audio_torch.utils.compile_cache import (compile_cache_dir,
                                                  enable_compile_cache)

path = compile_cache_dir()
if path is not None:
    enable_compile_cache(path)
lib = _build.host_library()
print("DIR", _build.build_dir())
print("COMPILES", _build.compiles)
print("LOADED", lib._name)
if len(sys.argv) > 1:               # a library has loaded: moving raises
    try:
        enable_compile_cache(sys.argv[1])
        print("MOVE done")
    except RuntimeError:
        print("MOVE refused")
"""


def _child(env_cache, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("MMLA_COMPILE_CACHE", None)
    if env_cache is not None:
        env["MMLA_COMPILE_CACHE"] = str(env_cache)
    out = subprocess.run([sys.executable, "-c", _CHILD, *map(str, args)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    return lines


def test_cross_process_cache_hit(tmp_path):
    cache = tmp_path / "kernel_cache"
    first = _child(cache)
    assert Path(first["DIR"]) == cache
    assert int(first["COMPILES"]) == 1
    assert Path(first["LOADED"]).parent == cache
    assert any(cache.glob("libmmla_host-*.so"))
    second = _child(cache, tmp_path / "elsewhere")
    assert int(second["COMPILES"]) == 0, "the second process recompiled"
    assert second["LOADED"] == first["LOADED"]
    assert second["MOVE"] == "refused"


def test_default_build_dir_without_a_cache():
    got = _child("off")
    assert Path(got["DIR"]) == _build.BUILD_DIR
    assert Path(got["LOADED"]).parent == _build.BUILD_DIR


def test_cache_dir_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("MMLA_COMPILE_CACHE", raising=False)
    assert cc.compile_cache_dir(None) is None
    assert cc.compile_cache_dir("exp") == Path("exp") / ".kernel_cache"
    monkeypatch.setenv("MMLA_COMPILE_CACHE", str(tmp_path / "env"))
    assert cc.compile_cache_dir("exp") == tmp_path / "env"
    for off in ("0", "off", "none"):
        monkeypatch.setenv("MMLA_COMPILE_CACHE", off)
        assert cc.compile_cache_dir("exp") is None


def test_cli_flag_resolution(tmp_path, monkeypatch):
    """``--compile-cache DIR|off`` > ``MMLA_COMPILE_CACHE`` > the default
    build directory (nothing enabled)."""
    monkeypatch.delenv("MMLA_COMPILE_CACHE", raising=False)
    seen = []
    monkeypatch.setattr(cc, "enable_compile_cache",
                        lambda p: seen.append(Path(p)))

    def run(flag):
        cli._setup_compile_cache(argparse.Namespace(compile_cache=flag,
                                                    root=str(tmp_path)))

    run(None)
    assert seen == [], "no cache without the flag or the variable"
    run("off")
    assert seen == []
    run(str(tmp_path / "explicit"))
    assert seen == [tmp_path / "explicit"]
    monkeypatch.setenv("MMLA_COMPILE_CACHE", str(tmp_path / "env"))
    run(None)
    assert seen[-1] == tmp_path / "env"
    run("off")
    monkeypatch.setenv("MMLA_COMPILE_CACHE", "off")
    run(None)
    assert len(seen) == 2


def test_enable_failure_is_nonfatal(tmp_path, capsys):
    """An uncreatable directory warns, returns None and keeps the build
    directory."""
    before = _build.build_dir()
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    assert cc.enable_compile_cache(blocker / "cache") is None
    assert "compile cache disabled" in capsys.readouterr().err
    assert _build.build_dir() == before


def test_enable_existing_readonly_dir_is_nonfatal(tmp_path, capsys,
                                                  monkeypatch):
    """A read-only directory (simulated: root ignores chmod) warns too."""
    ro = tmp_path / "ro_cache"
    ro.mkdir()
    before = _build.build_dir()
    real_access = os.access
    monkeypatch.setattr(
        cc.os, "access",
        lambda p, mode: False if Path(p) == ro else real_access(p, mode))
    assert cc.enable_compile_cache(ro) is None
    assert "not writable" in capsys.readouterr().err
    assert _build.build_dir() == before


def test_enable_points_the_builds_at_the_cache(tmp_path, monkeypatch):
    """The happy path creates the directory and moves the build directory
    there (in this process nothing has loaded yet for the purpose of the
    check; the cross-process test shows the real effect)."""
    monkeypatch.setattr(_build, "_build_dir", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_loaded", lambda: False)
    path = cc.enable_compile_cache(tmp_path / "cache")
    assert path == tmp_path / "cache" and path.is_dir()
    assert _build.build_dir() == path
    assert cc.enable_compile_cache(tmp_path / "cache") == path   # idempotent


def test_moving_after_a_load_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_build_dir", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_loaded", lambda: True)
    with pytest.raises(RuntimeError, match="already loaded"):
        cc.enable_compile_cache(tmp_path / "late")
    assert _build.build_dir() == _build.BUILD_DIR
    # the directory it already uses is no move
    assert cc.enable_compile_cache(_build.BUILD_DIR) == _build.BUILD_DIR
