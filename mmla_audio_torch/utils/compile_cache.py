"""Persistent kernel cache for process restarts (counterpart of
``mmla_audio_tpu.utils.compile_cache``).

The JAX package's cold start is XLA compilation, and its cache is XLA's
persistent compilation cache.  The port's cold start is ``nvcc`` (and
``g++`` for the host library): each kernel library is built at first use
(``_build.py``), its file name a hash of its sources and flags.  The cache
is the directory those builds go to: a restarted process, or another
process on the same directory, finds its libraries there and runs no
compiler.

* ``compile_cache_dir(root)`` resolves the directory with the JAX
  package's precedence: ``$MMLA_COMPILE_CACHE`` wins (``0``, ``off`` or
  ``none``: no cache), else ``<root>/.kernel_cache`` when a root is given,
  else None.
* ``enable_compile_cache(path)`` points every later build at ``path``.
  Without it the builds go to the package's own git-ignored ``_build/``,
  as they always have: the port has a cache by default, where the JAX
  package's is opt-in.  An uncreatable or unwritable path warns once on
  stderr and keeps that default: enabling the cache can never break
  serving.  Calling it after a library has loaded from another directory
  raises (``_build.set_build_dir``): that library would not move.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

__all__ = ["enable_compile_cache", "compile_cache_dir"]

_ENV_DIR = "MMLA_COMPILE_CACHE"


def compile_cache_dir(root=None):
    """``$MMLA_COMPILE_CACHE`` (``0``/``off``/``none``: None), else
    ``<root>/.kernel_cache`` when a root is given, else None."""
    env = os.environ.get(_ENV_DIR)
    if env:
        return None if env in ("0", "off", "none") else Path(env)
    if root is not None:
        return Path(root) / ".kernel_cache"
    return None


def enable_compile_cache(path) -> Path | None:
    """Build every later kernel library into ``path`` (created if missing)
    and load them from there.  Idempotent.  Returns the path, or None after
    a warning when the directory cannot be created or written (the default
    build directory stays)."""
    from mmla_audio_torch import _build

    path = Path(path)
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        print(f"[WARN] compile cache disabled: cannot create {path}: {e}",
              file=sys.stderr)
        return None
    if not os.access(path, os.W_OK):
        print(f"[WARN] compile cache disabled: {path} is not writable",
              file=sys.stderr)
        return None
    return _build.set_build_dir(path)
