"""The lanes of K1's compiled general improve, on the CPU: the host's rule
(``ops/dense_backup.general_lanes``) and the reduction the kernel's lanes
make (csrc/dense_backup.cuh, dense_backup_general_kernel), written here in
numpy and held to the sequential first-index argmin. The kernel itself runs
only on the card: tests/test_torch_kernels.py holds it there, at every lane
count, bit for bit to one lane and to the run-time-d kernel.
"""

from torch_port_testing import random_v  # first: pins torch's threads

import numpy as np
import pytest
import torch

from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.ops import dense_backup as db

H100_SMS = 132   # an H100 SXM's SMs
BIG = np.float32(3.4e38)   # the kernel's running min starts here


@pytest.mark.parametrize("shape,n_cand", [((41,) * 4, 9), ((6,) * 8, 3)])
def test_lane_rule_keeps_one_lane_where_the_grid_fills_the_card(shape, n_cand):
    """The glider at 41^4 and the eight-state family at 6^8 run as before."""
    assert db.general_lanes(int(np.prod(shape)), n_cand, H100_SMS) == 1


@pytest.mark.parametrize("shape,n_cand", [((201, 201), 243), ((15, 11, 11, 11), 9)])
def test_lane_rule_gives_small_grids_several_lanes(shape, n_cand):
    """The du = 5 problem at 201^2 and the glider's (15, 11, 11, 11)."""
    assert db.general_lanes(int(np.prod(shape)), n_cand, H100_SMS) > 1


@pytest.mark.parametrize("n_sms", [66, 132])
@pytest.mark.parametrize("n_cand", [1, 3, 9, 243])
@pytest.mark.parametrize("n_nodes", [441, 19_965, 40_401, 540_671, 2_825_761])
def test_lane_rule_is_the_fewest_powers_of_two_that_fill_the_waves(n_nodes, n_cand, n_sms):
    """A power of two, at most SECTOR_LANES and never more than the
    candidates; enough lanes for LANE_WAVES waves of resident threads
    unless capped, and no more than needed."""
    lanes = db.general_lanes(n_nodes, n_cand, n_sms)
    want = db.LANE_WAVES * db.SM_THREADS * n_sms
    cap = min(db.SECTOR_LANES, n_cand)
    assert db.SECTOR_LANES <= db.MAX_LANES
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= max(1, cap)
    assert n_nodes * lanes >= want or 2 * lanes > cap
    assert lanes == 1 or n_nodes * (lanes // 2) < want


def _sequential(rhs):
    """The one-lane walk: strict `<` running min from (BIG, 0)."""
    best_v = np.full(rhs.shape[1], BIG, np.float32)
    best_c = np.zeros(rhs.shape[1], np.int64)
    for c in range(rhs.shape[0]):
        take = rhs[c] < best_v                 # NaN never takes
        best_v[take], best_c[take] = rhs[c][take], c
    return best_v, best_c


def _lanes(rhs, lanes):
    """The kernel's lanes: lane l walks candidates l, l + L, ... as the
    sequential walk does, then the xor butterfly keeps the smaller value,
    and on equal values the smaller index."""
    v = np.full((lanes, rhs.shape[1]), BIG, np.float32)
    c = np.zeros((lanes, rhs.shape[1]), np.int64)
    for lane in range(lanes):
        sub_v, sub_c = _sequential(rhs[lane::lanes])
        v[lane], c[lane] = sub_v, lane + lanes * sub_c
    off = lanes // 2
    while off:
        ov, oc = v[np.arange(lanes) ^ off], c[np.arange(lanes) ^ off]
        take = (ov < v) | ((ov == v) & (oc < c))
        v, c = np.where(take, ov, v), np.where(take, oc, c)
        off //= 2
    assert (v == v[:1]).all() and (c == c[:1]).all()   # every lane agrees
    return v[0], c[0]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_lane_reduction_is_the_first_index_argmin(lanes):
    """Rows of tied values, of NaN, of values at or above 3.4e38 and of
    signed zeros: value and index as the sequential walk gives them."""
    rng = np.random.default_rng(lanes)
    C, N = 37, 4000
    rhs = rng.integers(0, 6, (C, N)).astype(np.float32)   # many ties
    rhs[rng.random((C, N)) < 0.1] = np.nan
    rhs[rng.random((C, N)) < 0.1] = np.inf
    rhs[:, :50] = np.nan                                    # no finite rhs
    rhs[:, 50:100] = BIG                                    # none below 3.4e38
    rhs[:, 100:150] = rng.choice([np.float32(0.0), np.float32(-0.0)], (C, 50))
    want_v, want_c = _sequential(rhs)
    got_v, got_c = _lanes(rhs, lanes)
    np.testing.assert_array_equal(got_c, want_c)
    assert (got_v.view(np.int32) == want_v.view(np.int32)).all()   # bits, signed zeros too
    assert (got_c[:100] == 0).all()


def test_lanes_switch_is_ignored_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version, whatever _lanes."""
    tp = tm.make_problem("glider")
    grid = tp.default_grid((5, 4, 4, 3))
    ops = db.make_dense_operands(tp, grid, tp.control_candidates(3), "cpu")
    v = torch.as_tensor(random_v(grid.shape))
    want, wbest = db.dense_backup_reference(ops, v)
    for lanes in (None, 8, 3):
        got, best = db.dense_backup_general(ops, v, _lanes=lanes)
        assert torch.equal(got, want) and torch.equal(best, wbest)
