"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
a source, all started together, and links the objects into one shared
library with a plain C interface, which is loaded with ``ctypes``.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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


def _run(cmds):
    """Run the commands at once; (their logs, in order, and the first
    failure's message or None)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed with code {proc.returncode}:\n{out[-6000:]}"
    return logs, failed


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
        tag = f"{os.getpid()}.tmp"
        units = [s for s in _sources() if s.suffix == ".cu"]
        objs = [out / f"{s.stem}.{tag}.o" for s in units]
        logs, failed = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                             for s, o in zip(units, objs)])
        tmp = out / f"{LIB_NAME}.{tag}"
        if failed is None:
            link, failed = _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
            logs += link
        (out / "build.log").write_text("\n".join(logs))
        for o in objs:
            o.unlink(missing_ok=True)
        if failed is not None:
            raise RuntimeError(failed)
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(lib_path))
