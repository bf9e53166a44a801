"""Build and load the port's CUDA kernels.

The sources under ``alphatpu_torch/csrc/`` are compiled by ``nvcc`` into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds) and loaded with ``ctypes``.  The library lands in
``alphatpu_torch/_build/`` under a name that hashes the sources and the
flags, so an edited source is rebuilt on its next use.  Nothing is built
at import: the first kernel launch calls :func:`load_library`.

Flags: Hopper only (``sm_90a``), ``-fmad=false`` so that no multiply-add is
contracted, and nvcc's default IEEE division and square root (no
``--use_fast_math``) - each element then rounds like the plain torch
versions the kernels are held to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # pointers x 19, A, V, G, D, cpuct, scale, stream
    "launch_select_apply_packed": [_P] * 19 + [_I] * 4
                                  + [ctypes.c_float, _I, _P],
    # pointers x 6, A, V, G, D, stream
    "launch_backup": [_P] * 6 + [_I] * 4 + [_P],
}

# what the last build in this process printed (ptxas's register, stack
# and spill report); empty when the library was already built
build_report = {"log": ""}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libalphatpu_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_report["log"] = proc.stdout + proc.stderr
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, with every entry
    point's argument types declared (each returns a cudaError_t as int)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
