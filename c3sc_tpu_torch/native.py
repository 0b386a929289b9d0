"""ctypes bindings for the native host-runtime library (``native/``) — port
of ``c3sc_tpu/native.py``.

Native components (``native/c3sc_native.cpp``, host code, not a device
kernel): greedy maxvol pivot selection (C3 ``qmarray_maxvol1d`` parity) and
the compact binary TT serializer (``function_train_save`` / ``valuef_save``
parity: active rank blocks only). The library is the one the JAX package
loads, from the same path and by the same two routes: the shared library
where ``native/libc3sc_native.so`` exists (``make -C native``), numpy
otherwise. A library that exists but does not load raises: the error is
reported, not swallowed. ``have_native()`` says whether the library is
loaded; ``tt_save_binary`` returns the route that wrote each file.

The ``.c3tt`` layout is the JAX package's, byte for byte: magic ``C3TT``,
uint32 version 1 and dtype code 0 (float32), int64 d, int64 ranks [d+1],
int64 sizes [d], then each active core [r_k, n_k, r_{k+1}] in float32, C
order. ``tt_to_active`` and ``tt_from_active`` move between it and the
port's padded ``TT``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.ops.tt import TT

LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native", "libc3sc_native.so")


@functools.cache
def _load():
    """The native library, or None where it has not been built."""
    if not os.path.exists(LIB_PATH):
        return None
    lib = ctypes.CDLL(LIB_PATH)
    lib.c3sc_maxvol.restype = ctypes.c_int
    lib.c3sc_maxvol.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_double, ctypes.c_int,
    ]
    lib.c3sc_tt_save.restype = ctypes.c_int
    lib.c3sc_tt_load_header.restype = ctypes.c_int
    lib.c3sc_tt_load_cores.restype = ctypes.c_int
    return lib


def have_native() -> bool:
    return _load() is not None


# ------------------------------------------------------------------- maxvol


def maxvol(A: np.ndarray, tol: float = 0.05, max_iters: int = 100) -> np.ndarray:
    """Rows (len r) of A [m, r] maximizing submatrix volume.

    Native greedy maxvol when available; numpy LU + swap otherwise.
    """
    A = np.ascontiguousarray(A, np.float64)
    m, r = A.shape
    lib = _load()
    rows = np.zeros(r, np.int64)
    if lib is not None:
        ret = lib.c3sc_maxvol(
            A.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            m, r, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tol, max_iters,
        )
        if ret >= 0:
            return rows
    return _maxvol_numpy(A, tol, max_iters)


def _maxvol_numpy(A, tol, max_iters):
    import scipy.linalg

    m, r = A.shape
    piv = scipy.linalg.lu_factor(A)[1]
    order = np.arange(m)
    for i, p in enumerate(piv[:r]):
        order[i], order[p] = order[p], order[i]
    rows = order[:r].copy()
    for _ in range(max_iters):
        B = A @ np.linalg.inv(A[rows])
        i, j = np.unravel_index(np.argmax(np.abs(B)), B.shape)
        if abs(B[i, j]) <= 1.0 + tol:
            break
        rows[j] = i
    return rows


# ------------------------------------------------------------ serialization


def _header(cores_active):
    d = len(cores_active)
    ranks = np.asarray([cores_active[0].shape[0]] + [c.shape[2] for c in cores_active], np.int64)
    n = np.asarray([c.shape[1] for c in cores_active], np.int64)
    return d, ranks, n


def tt_save_binary(path: str, cores_active: list[np.ndarray]) -> str:
    """Save active-block cores [(r_k, n_k, r_{k+1})] in the C3TT format: by
    the native library where it is built, else by numpy (the same bytes).
    Returns the route that wrote the file, ``"native"`` or ``"numpy"``: the
    library's writer may fail and hand the file to numpy."""
    lib = _load()
    d, ranks, n = _header(cores_active)
    cores32 = [np.ascontiguousarray(c, np.float32) for c in cores_active]
    if lib is not None:
        arr_t = ctypes.POINTER(ctypes.c_float) * d
        ptrs = arr_t(*[c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for c in cores32])
        ret = lib.c3sc_tt_save(
            path.encode(), d,
            ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ptrs,
        )
        if ret == 0:
            return "native"
    tt_save_binary_numpy(path, cores32)
    return "numpy"


def tt_save_binary_numpy(path: str, cores_active: list[np.ndarray]) -> None:
    """The numpy writer of the C3TT format (the route without the library)."""
    d, ranks, n = _header(cores_active)
    with open(path, "wb") as f:
        f.write(b"C3TT")
        f.write(np.asarray([1, 0], np.uint32).tobytes())
        f.write(np.asarray([d], np.int64).tobytes())
        f.write(ranks.tobytes())
        f.write(n.tobytes())
        for c in cores_active:
            f.write(np.ascontiguousarray(c, np.float32).tobytes())


def tt_load_binary(path: str) -> list[np.ndarray]:
    """Load active-block cores from the C3TT format."""
    with open(path, "rb") as f:
        if f.read(4) != b"C3TT":
            raise ValueError(f"{path} is not a C3TT file")
        _version, dtype_code = np.frombuffer(f.read(8), np.uint32)
        if dtype_code != 0:
            raise ValueError(f"{path}: dtype code {dtype_code}, only 0 (float32) is defined")
        d = int(np.frombuffer(f.read(8), np.int64)[0])
        ranks = np.frombuffer(f.read(8 * (d + 1)), np.int64)
        n = np.frombuffer(f.read(8 * d), np.int64)
        cores = []
        for k in range(d):
            sz = int(ranks[k] * n[k] * ranks[k + 1])
            c = np.frombuffer(f.read(4 * sz), np.float32)
            cores.append(c.reshape(ranks[k], n[k], ranks[k + 1]).copy())
    return cores


def tt_to_active(tt: TT) -> list[np.ndarray]:
    """The active blocks of a padded TT, as numpy."""
    ranks = tt.ranks.detach().cpu().numpy()
    return [c[: ranks[k], :, : ranks[k + 1]].detach().cpu().numpy()
            for k, c in enumerate(tt.cores)]


def tt_from_active(cores_active: list[np.ndarray], rmax: int, device=None) -> TT:
    """Pack active blocks into a TT padded to ``rmax``, on ``device`` (None:
    the default CUDA device)."""
    dev = resolve_device(device)
    cores = []
    for c in cores_active:
        buf = np.zeros((rmax, c.shape[1], rmax), c.dtype)
        buf[: c.shape[0], :, : c.shape[2]] = c
        cores.append(torch.as_tensor(buf, device=dev))
    ranks = [1] + [c.shape[2] for c in cores_active]
    return TT(tuple(cores), torch.as_tensor(np.asarray(ranks, np.int32), device=dev))
