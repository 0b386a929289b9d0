"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library lands in ``_build/<hash>/``, keyed by a hash of the sources and
flags, and is built at first use: on a machine with the CUDA toolkit,
calling ``load()`` (or any kernel wrapper on a CUDA tensor) is enough.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libc3sc_torch_kernels.so"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of c3sc_tpu_torch are built from csrc/ at first use")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> pathlib.Path:
    """Directory of the library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD / digest.hexdigest()[:16]


@functools.cache
def load() -> ctypes.CDLL:
    """Build the kernels if needed and load them (once per process).

    ``nvcc``'s output, including ``-Xptxas -v``'s registers and spills per
    kernel, is kept in ``build.log`` beside the library.
    """
    out = build_dir()
    lib_path = out / LIB_NAME
    if not lib_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources() if s.suffix == ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stderr[-6000:]}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(lib_path))
