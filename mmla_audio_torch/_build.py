"""Build-at-first-use for the port's native code.

Two kinds of shared library, all loaded with ctypes and all built into the
build directory: by default the git-ignored ``mmla_audio_torch/_build/``
(never the JAX package), or the directory that
``utils.compile_cache.enable_compile_cache`` names (``--compile-cache``,
``$MMLA_COMPILE_CACHE``), so that a read-only install or a restarted
process keeps its built kernels where the user says:

* one library per CUDA source under ``csrc/``, compiled with ``nvcc`` for
  ``sm_90a`` (``cuda_libraries`` starts every nvcc at once);
* the host library ``libmmla_host.so`` (webrtcvad engine, ring buffer, WAV
  IO) from ``csrc/host/``, unchanged copies of the JAX package's C++
  sources, with its Makefile's flags.

Each library's file name carries a hash of its sources and flags, so a stale
build is never loaded.  Builds write to a temporary name and rename into
place, so concurrent processes (test workers) never load a half-written file.
``compiles`` counts the compiler runs of this process: a process that finds
every library in its build directory runs none; ``found`` counts the
libraries it found built, and ``outcomes`` says of each library file
looked up whether this process ``"compiled"`` it or ``"found"`` it.  A
build or load of a library is the set-up span ``setup.kernels``
(``utils.timers``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from mmla_audio_torch.utils.timers import setup_span

__all__ = ["BUILD_DIR", "build_dir", "set_build_dir", "cuda_library",
           "cuda_libraries", "host_library", "nvcc"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"                 # the default build directory
_build_dir = BUILD_DIR
compiles = 0
found = 0
outcomes: dict = {}                         # library file -> how it came
_counted = threading.Lock()                 # builds run in pool threads
_P, _I, _LL, _D, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_double, ctypes.c_float)
# library name -> (source, {launch function: its argtypes})
CUDA_KERNELS = {
    "overlap_features": (
        _PKG / "csrc" / "overlap_features.cu",
        {"overlap_features_launch":
         [_P, _LL, _I, _I, _P, _P, _P] + [_I] * 7 + [_P]}),
    "fused_resblock": (
        _PKG / "csrc" / "fused_resblock.cu",
        {"fused_resblock_launch": [_P] * 10 + [_I] * 4 + [_P],
         "fused_resblock_mma_launch": [_P] * 10 + [_I] * 8 + [_P]}),
    "webrtc_vad": (
        _PKG / "csrc" / "webrtc_vad.cu",
        {"webrtc_vad_launch":
         [_P, _LL] + [_I] * 5 + [_P, _I, _P, _P, _P],
         "vad_collect_launch": [_P, _I, _I, _P, _D, _I, _P, _P, _P]}),
    "denoise": (
        _PKG / "csrc" / "denoise.cu",
        {"stft_rfft_launch": [_P, _LL, _I, _I, _I, _P, _P, _P],
         "istft_irfft_launch": [_P, _P, _I, _P, _P, _P],
         "smooth_mask_launch":
         [_P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _P]}),
    "gmm_vad": (
        _PKG / "csrc" / "gmm_vad.cu",
        {"gmm_vad_launch": [_P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P],
         "gmm_vad_windows_launch":
         [_P, _LL, _I, _I, _I, _P, _P, _P, _I, _P, _F, _F, _I]
         + [_P] * 5}),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# -fwrapv: the webrtcvad fixed-point engine relies on two's-complement
# wraparound of signed int32 arithmetic (same flags as the JAX package's
# native/Makefile).
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fwrapv", "-shared")


# the port's copies of the JAX package's native/*.cpp (a test pins them
# byte for byte to the originals)
HOST_SOURCES = tuple(_PKG / "csrc" / "host" / f
                     for f in ("ringbuffer.cpp", "wavio.cpp", "webrtcvad.cpp"))


def build_dir() -> Path:
    """The directory every build of this process goes to."""
    return _build_dir


def _loaded() -> bool:
    return bool(cuda_library.cache_info().currsize
                or host_library.cache_info().currsize)


def set_build_dir(path) -> Path:
    """Point every later build at ``path`` (made if missing).  Raises once
    a library has loaded from another directory: a loaded library would not
    move."""
    global _build_dir
    path = Path(path)
    if path.resolve() == _build_dir.resolve():
        return _build_dir
    if _loaded():
        raise RuntimeError(f"the build directory cannot move to {path}: a "
                           f"library already loaded from {_build_dir}")
    path.mkdir(parents=True, exist_ok=True)
    _build_dir = path
    return path


def _build(name: str, compiler: str, flags, sources) -> Path:
    global compiles, found
    digest = hashlib.sha1()
    for part in (compiler, *flags):
        digest.update(part.encode())
    for src in sources:
        digest.update(src.read_bytes())
    target = _build_dir / f"{name}-{digest.hexdigest()[:12]}.so"
    if target.exists():
        with _counted:
            found += 1
            outcomes.setdefault(target.name, "found")
        return target
    _build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir)
    os.close(fd)
    with _counted:
        compiles += 1
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp,
                               *(str(s) for s in sources)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed building "
                               f"{name}:\n{proc.stderr}")
        os.replace(tmp, target)
        with _counted:
            outcomes[target.name] = "compiled"
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    # torch's search (the CUDA_HOME variable, then the usual places) costs
    # an import of torch.utils.cpp_extension: only where PATH has no nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _cuda_build(name: str) -> Path:
    return _build(f"lib{name}", nvcc(), NVCC_FLAGS, (CUDA_KERNELS[name][0],))


@setup_span("setup.kernels")
def cuda_libraries() -> dict:
    """Build every CUDA library at once (one nvcc per source, in parallel)
    and load them: ``{name: CDLL}``."""
    with ThreadPoolExecutor(len(CUDA_KERNELS)) as pool:
        return dict(zip(CUDA_KERNELS, pool.map(cuda_library, CUDA_KERNELS)))


@functools.lru_cache(maxsize=None)
@setup_span("setup.kernels")
def cuda_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load one CUDA kernel library, its
    launch functions typed."""
    lib = ctypes.CDLL(str(_cuda_build(name)))
    for fn_name, argtypes in CUDA_KERNELS[name][1].items():
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
@setup_span("setup.kernels")
def host_library() -> ctypes.CDLL:
    """Build (once per source hash) and load ``libmmla_host.so``."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    return ctypes.CDLL(str(_build("libmmla_host", cxx, CXX_FLAGS,
                                  HOST_SOURCES)))
