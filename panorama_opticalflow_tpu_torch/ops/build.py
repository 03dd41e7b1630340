"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, with the
headers ``*.cuh`` and ``*.inc`` they include).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library is
named after a hash of the sources and the flags, so the first use after
any edit rebuilds it; it goes to ``build/kernels/`` at the repository
root (listed in ``.gitignore``).  Nothing is built when this module is
imported: ``load()`` builds on first use, which only happens when a
wrapper in ``ops.kernels`` receives a CUDA tensor.  ``open_library`` builds
and binds another source directory with the same C interface (an earlier
commit's ``csrc/``) and ``use_library`` hands it to the wrappers, for
timing two versions of a kernel in one process.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC", "--threads", "0"]

_lib = None
build_log = ""        # nvcc's output of the last build (register/smem use)
build_seconds = 0.0   # wall time of the last build, 0 when it was cached

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong
# name: (argument types, return type); a launch returns its cudaError_t
_SIGNATURES = {
    "pano_warp_tiled": ([_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _f, _p],
                        _i),
    "pano_median5": ([_p, _p, _i, _i, _i, _p], _i),
    "pano_median5_diffuse": ([_p, _p, _p, _i, _i, _i, _p, _i, _p], _i),
    "pano_relax_phase_fused": ([_p] * 11 + [_i] * 5 + [_p, _i] + [_f] * 5
                               + [_i, _i, _p], _i),
    "pano_relax_phase_unfused": ([_p] * 13 + [_i] * 5 + [_f] * 5
                                 + [_i, _i, _p], _i),
    "pano_small_median5_diffuse": ([_p, _p, _p, _i, _i, _i, _p, _i, _p], _i),
    "pano_small_relax_phase_fused": ([_p] * 11 + [_i] * 5 + [_p, _i]
                                     + [_f] * 6 + [_i, _i, _p], _i),
    "pano_small_relax_phase_unfused": ([_p] * 13 + [_i] * 5 + [_f] * 6
                                       + [_i, _i, _p], _i),
    "pano_relax_smem": ([_i] * 4, _ll),
    "pano_small_relax_smem": ([_i] * 4, _ll),
    "pano_smem_limit": ([], _ll),
    "pano_median5_diffuse_smem": ([_i], _ll),
    "pano_exact_level": ([_p] * 7 + [_i] * 5 + [_p, _i] + [_f] * 8 + [_p],
                         _i),
    "pano_exact_level_smem": ([_i], _ll),
    "pano_novel_view": ([_p] * 6 + [_i] * 4 + [_ll] * 4 + [_p, _ll, _f, _i,
                                                          _p], _i),
    "pano_eight_ray": ([_p] * 3 + [_i] * 3 + [_ll] * 3 + [_i] * 3
                       + [_f, _f, _p], _i),
    "pano_hole_composite": ([_p] * 5 + [_i] * 3 + [_p, _ll, _i, _i, _p], _i),
}


def _sources(csrc: str) -> list[str]:
    return sorted(path for ext in ("cu", "cuh", "inc")
                  for path in glob.glob(os.path.join(csrc, f"*.{ext}")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ on the machine with the card")


def library_path(csrc: str = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(csrc):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libpano_kernels_{h.hexdigest()[:16]}.so")


def build(csrc: str = CSRC) -> str:
    """Compile the sources of ``csrc`` into the hashed library unless it
    exists; returns its path."""
    global build_log, build_seconds
    path = library_path(csrc)
    if os.path.exists(path):
        build_seconds = 0.0
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cu = [s for s in _sources(csrc) if s.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", csrc, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0
    return path


def open_library(csrc: str = CSRC) -> ctypes.CDLL:
    """Build the sources of ``csrc`` and bind their C interface (an earlier
    commit's sources may lack a function added since; it stays unbound)."""
    lib = ctypes.CDLL(build(csrc))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = open_library()
    return _lib


def use_library(lib: ctypes.CDLL) -> None:
    """Make ``lib`` (from ``open_library``) the one ``load()`` returns, so
    the wrappers launch its kernels."""
    global _lib
    _lib = lib
