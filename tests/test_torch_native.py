"""The port's bindings of the native library (c3sc_tpu_torch.native)
against the JAX package's (c3sc_tpu.native), on the CPU: the same library,
loaded from the same path by the same two routes (the shared library, numpy
without it).

Bars, each stated at its test: the same active cores give byte-identical
.c3tt files from both packages, by the library and by the numpy writer;
maxvol rows equal; tests/test_native.py's bars on the port (maxvol
property within 1.2, volume within a factor 5 of the numpy route's, the
binary round trip within float32 rounding, the file a tenth of the padded
npz).
"""

from torch_port_testing import random_tt_numpy  # first: pins torch's threads

import os

import numpy as np
import pytest
import torch

from c3sc_tpu import native as jn
from c3sc_tpu_torch import native as tn
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops import tt as ttt

CPU = "cpu"


def _active(seed=0, shape=(7, 9, 8), ranks=(3, 4), rmax=12):
    cores, rk = random_tt_numpy(shape, ranks, rmax, seed)
    return cores, rk, [c[: rk[k], :, : rk[k + 1]] for k, c in enumerate(cores)]


class _FailingLibrary:
    """A loaded native library whose C3TT writer reports an error."""

    @staticmethod
    def c3sc_tt_save(*args):
        return 1


def test_c3tt_writer_reports_its_route(tmp_path, monkeypatch):
    """tt_save_binary returns the route that wrote the file: the library
    where it is loaded, numpy where it is not or where its writer fails;
    every route writes the same bytes."""
    _, _, active = _active(seed=3)
    want = "native" if tn.have_native() else "numpy"
    assert tn.tt_save_binary(str(tmp_path / "default.c3tt"), active) == want
    monkeypatch.setattr(tn, "_load", lambda: _FailingLibrary)
    assert tn.tt_save_binary(str(tmp_path / "failed.c3tt"), active) == "numpy"
    monkeypatch.setattr(tn, "_load", lambda: None)
    assert tn.tt_save_binary(str(tmp_path / "absent.c3tt"), active) == "numpy"
    blobs = {open(str(tmp_path / f"{n}.c3tt"), "rb").read()
             for n in ("default", "failed", "absent")}
    assert len(blobs) == 1


def test_c3tt_files_are_byte_identical(tmp_path, monkeypatch):
    cores, rk, active = _active()
    tt = tt_from_numpy(cores, rk, CPU)
    for a, b in zip(tn.tt_to_active(tt), active):
        np.testing.assert_array_equal(a, b)
    assert tn.have_native() == jn.have_native()
    paths = {}
    for name, save in (("port", tn.tt_save_binary), ("port-numpy", tn.tt_save_binary_numpy),
                       ("jax", jn.tt_save_binary)):
        paths[name] = str(tmp_path / f"{name}.c3tt")
        save(paths[name], tn.tt_to_active(tt))
    monkeypatch.setattr(jn, "_load", lambda: None)          # the JAX package's numpy route
    paths["jax-numpy"] = str(tmp_path / "jax-numpy.c3tt")
    jn.tt_save_binary(paths["jax-numpy"], active)
    blobs = {name: open(p, "rb").read() for name, p in paths.items()}
    assert len(set(blobs.values())) == 1, {k: len(v) for k, v in blobs.items()}
    for a, b in zip(tn.tt_load_binary(paths["jax"]), active):
        np.testing.assert_array_equal(a, b)
    back = tn.tt_from_active(tn.tt_load_binary(paths["port"]), rmax=12, device=CPU)
    for a, b in zip(back.cores, cores):
        np.testing.assert_array_equal(a.numpy(), b)
    assert back.ranks.tolist() == rk.tolist()
    with open(str(tmp_path / "bad.c3tt"), "wb") as f:
        f.write(b"NOPE")
    with pytest.raises(ValueError):
        tn.tt_load_binary(str(tmp_path / "bad.c3tt"))


@pytest.mark.parametrize("seed,m,r", [(0, 200, 8), (1, 100, 6)])
def test_maxvol_rows_equal_and_bars(seed, m, r, monkeypatch):
    A = np.random.default_rng(seed).standard_normal((m, r))
    rows = tn.maxvol(A)
    np.testing.assert_array_equal(rows, jn.maxvol(A))
    np.testing.assert_array_equal(tn._maxvol_numpy(A, 0.05, 100), jn._maxvol_numpy(A, 0.05, 100))
    assert rows.shape == (r,) and len(set(rows.tolist())) == r
    assert np.abs(A @ np.linalg.inv(A[rows])).max() <= 1.2
    vol_f = abs(np.linalg.det(A[tn._maxvol_numpy(A, 0.05, 100)]))
    assert abs(np.linalg.det(A[rows])) > 0.2 * vol_f


def test_binary_roundtrip_and_size(tmp_path):
    """tests/test_native.py's round trip (evaluations within float32
    rounding) and size bars on the port's TT."""
    cores, rk, _ = _active(seed=3)
    tt = tt_from_numpy(cores, rk, CPU)
    p = str(tmp_path / "vf.c3tt")
    tn.tt_save_binary(p, tn.tt_to_active(tt))
    tt2 = tn.tt_from_active(tn.tt_load_binary(p), rmax=12, device=CPU)
    idx = torch.as_tensor(np.stack(np.meshgrid(*[np.arange(n) for n in (7, 9, 8)],
                                               indexing="ij"), -1).reshape(-1, 3))
    torch.testing.assert_close(ttt.tt_gather_eval(tt2, idx), ttt.tt_gather_eval(tt, idx),
                               rtol=1e-5, atol=1e-6)
    big, brk = random_tt_numpy((31, 31, 31), (4, 4), 32, seed=1)
    big_tt = tt_from_numpy(big, brk, CPU)
    p1, p2 = str(tmp_path / "a.c3tt"), str(tmp_path / "a.npz")
    tn.tt_save_binary(p1, tn.tt_to_active(big_tt))
    ttt.tt_save(big_tt, p2)
    assert os.path.getsize(p1) < os.path.getsize(p2) / 10
