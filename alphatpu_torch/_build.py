"""Build and load the port's CUDA kernels.

The sources under ``alphatpu_torch/csrc/`` are compiled by ``nvcc`` into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds) and loaded with ``ctypes``: one ``nvcc -c`` per
``.cu`` file, all started together, then one link.  The library lands in
``alphatpu_torch/_build/`` under a name that hashes every source - the
``.cu`` files and the ``.cuh`` headers they include - and the flags, so an
edited source or header is rebuilt on its next use.  Nothing is built at
import: the first kernel launch calls :func:`load_library`, through
:func:`launch`, which every kernel wrapper calls.

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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the cooperative walk's launch geometry (kernels.WalkGeometry): lanes,
# slots, threads, blocks, smem, placement
_GEOMETRY = [_I] * 6
_SIGNATURES = {
    # pointers x 19, A, V, G, D, cpuct, scale, the geometry, stream
    "launch_select_apply_packed": [_P] * 19 + [_I] * 4 + [_F, _I]
                                  + _GEOMETRY + [_P],
    # pointers x 18, A, V, G, D, cpuct, bits_v, bits_w, scale, the
    # geometry, stream
    "launch_select_apply_packed1": [_P] * 18 + [_I] * 4 + [_F] + [_I] * 3
                                   + _GEOMETRY + [_P],
    # pointers x 20, A, V, G, D, cpuct, the geometry, stream
    "launch_select_apply": [_P] * 20 + [_I] * 4 + [_F] + _GEOMETRY + [_P],
    # pointers x 13, A, V, G, D, cpuct, the geometry, stream
    "launch_select": [_P] * 13 + [_I] * 4 + [_F] + _GEOMETRY + [_P],
    # pointers x 6, A, V, G, D, threads, blocks, stream
    "launch_backup": [_P] * 6 + [_I] * 6 + [_P],
    # the rules (games/kernels.py): pointers x 8, the host masks, G, the
    # action's width (32 or 64 bits), the geometry (rows, cols, words),
    # the launch (threads, blocks), stream
    "launch_reversi_play": [_P] * 9 + [_I] * 7 + [_P],
    # pointers x 6, the host masks, G, rows, cols, words, the launch
    # (threads, blocks), stream
    "launch_reversi_is_over": [_P] * 7 + [_I] * 6 + [_P],
    # pointers x 5, the host masks, G, rows, cols, words, nvict, the launch
    # (threads, blocks), stream
    "launch_line_is_over": [_P] * 6 + [_I] * 7 + [_P],
    # pointers x 4, the host masks, G, rows, cols, words, the launch (lanes
    # a game, threads, blocks), stream
    "launch_hex_is_over": [_P] * 5 + [_I] * 7 + [_P],
}
# the bf16 instantiations of the three-plane kernels take what their f32
# entries take
_SIGNATURES.update({name + "_bf16": _SIGNATURES[name] for name in (
    "launch_select_apply", "launch_select", "launch_backup")})

# what the last build in this process printed (ptxas's register, stack
# and spill report); empty when the library was already built
build_report = {"log": ""}


def sources() -> list[Path]:
    """The translation units: every ``.cu`` file, one object each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def hashed_sources() -> list[Path]:
    """Everything the build reads: the ``.cu`` files and their headers."""
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


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
    for src in hashed_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libalphatpu_kernels-{h.hexdigest()[:16]}.so"


def _start(cmd: list[str]):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _wait(started) -> str:
    """Wait for every started ``(cmd, Popen)``, then raise on the first
    that failed.  Returns their joined output."""
    outs = [p.communicate() for _, p in started]
    log = ""
    for (cmd, p), (out, err) in zip(started, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}{err}")
        log += out + err
    return log


def build() -> Path:
    """Compile the sources unless a library of the same hash exists: one
    ``nvcc -c`` per ``.cu`` file in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        log = _wait([_start([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj])
                     for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, out.name)
        log += _wait([_start([nvcc, "-shared", "-o", lib, *objs])])
        os.replace(lib, out)
    build_report["log"] = log
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


def on_cuda(kernel: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor (the kernel's plain
    version runs); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for {t.device}")
    return True


def launch(entry: str, device, *args) -> None:
    """Call the library's ``entry`` with ``args`` (tensors as pointers) and
    the current stream on ``device``; raise on a launch error."""
    lib = load_library()
    args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
