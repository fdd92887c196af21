"""The scheduling model's window counts without scans (``models/scheduling.py``):
the banded 0/1 matmuls against the cumulative-sum differences they replace,
both regions of a move in one ``region_deltas`` pass against the two separate
passes, and the descent's neighborhoods free of ``aten::cumsum``.

Equality is bit for bit: the float32 results are compared as their int32 bit
patterns."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from constraint_solver_tpu_torch.models import scheduling as ts
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from test_torch_scheduling import _specs


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _csum_counts(ind: torch.Tensor, width: int) -> torch.Tensor:
    """Window counts along the last axis as a cumulative-sum difference."""
    cs = torch.cat([torch.zeros(ind.shape[:-1] + (1,)), ind.cumsum(-1)], dim=-1)
    return cs[..., width:] - cs[..., :-width]


@pytest.mark.parametrize("width", [7, 14])
@pytest.mark.parametrize("days", [15, 31, 365])
def test_banded_window_counts_equal_cumsum_differences(days, width):
    """Both orientations of the band: per-window counts (the dense block's
    ``band @ oh`` and the region's ``ind @ band.T``) and the sum of per-window
    values over the windows containing each day (``band.T @ x``), on
    assignments that hold the -1...-4 padding ids."""
    n_emp = 6
    rng = np.random.default_rng(10 * days + width)
    a = torch.from_numpy(rng.integers(-4, n_emp, size=(3, days)))
    assert set(range(-4, 0)) <= set(a.unique().tolist())
    oh = ts._one_hot(a, n_emp)  # [3, D, E], zero rows at the padding
    band = ts._window_band(days, width, "cpu")
    assert band.shape == (days - width + 1, days)

    want = _csum_counts(oh.transpose(1, 2), width)  # [3, E, D - width + 1]
    np.testing.assert_array_equal(_bits(band @ oh), _bits(want.transpose(1, 2)))
    np.testing.assert_array_equal(_bits(oh.transpose(1, 2) @ band.T), _bits(want))

    # The windows containing day d start in [max(d - width + 1, 0), min(d, D - width)].
    x = (want == 1).to(torch.float32).transpose(1, 2)  # [3, D - width + 1, E]
    cx = torch.cat([torch.zeros(3, 1, n_emp), x.cumsum(1)], dim=1)
    d = torch.arange(days)
    hi, lo = d.clamp(max=days - width) + 1, (d - width + 1).clamp(min=0)
    np.testing.assert_array_equal(_bits(band.T @ x), _bits(cx[:, hi] - cx[:, lo]))


@pytest.mark.parametrize("near", [True, False], ids=["overlapping", "anywhere"])
def test_one_region_pass_equals_two(near):
    """``move_region_deltas`` (both regions stacked, one pass with the
    exclusion on) against the two ``region_deltas`` calls it replaces, at
    365 x 20, P = 2, 64 random moves (ChangeDay and SwapDays)."""
    d_days, n_emp, p, w = 365, 20, 2, 64
    _, tspec = _specs("365d20e")
    rng = np.random.default_rng(5 + near)
    assign = torch.from_numpy(rng.integers(0, n_emp, size=(p, d_days)))
    weekend = torch.as_tensor(tspec.is_weekend())
    pad = torch.zeros(ts.PAD, dtype=torch.bool)
    wk_pad = torch.cat([pad, weekend, pad])
    edge = assign.new_full((p, ts.PAD), -1)
    a_pad = torch.cat([edge, assign, edge], dim=1)
    d1 = torch.from_numpy(rng.integers(0, d_days, size=(p, w)))
    off = rng.integers(1, 20, size=(p, w)) if near else rng.integers(1, d_days, size=(p, w))
    d2 = (d1 + torch.from_numpy(off)) % d_days
    is_swap = torch.from_numpy(rng.random((p, w)) < 0.8)
    e1, e2 = assign.gather(1, d1), assign.gather(1, d2)
    n1 = torch.where(is_swap, e2, torch.from_numpy(rng.integers(0, n_emp, size=(p, w))))
    n2 = torch.where(is_swap, e1, e2)

    got = ts.move_region_deltas(a_pad, wk_pad, d1, n1, d2, n2, e1, e2, d_days)
    reg = torch.arange(ts.REG)
    for half, (dj, dx, excl) in enumerate(((d1, d2, False), (d2, d1, True))):
        at = dj[..., None] + reg
        sl = a_pad.gather(1, at.reshape(p, -1)).view(p, w, ts.REG)
        want = ts.region_deltas(sl, wk_pad[at], d1, n1, d2, n2, e1, e2, dj, dx, excl, d_days)
        for wv, gv in zip(want, got):
            np.testing.assert_array_equal(_bits(gv[:, half]), _bits(wv))
    assert (got[0] != 0).any() and (got[1] != 0).any()


class _OpNames(TorchDispatchMode):
    """The ATen ops that run under it, by name."""

    def __init__(self):
        super().__init__()
        self.names = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("proposer", ["dense", "random"])
def test_descent_neighborhoods_run_no_cumsum(proposer):
    """One neighborhood of the dense proposer (its ChangeDay block, 256 random
    swaps through ``exact_move_deltas`` and the swap diagonals) and of the
    random proposer (``exact_move_deltas`` alone) at 365 x 20 runs no
    cumulative sum and runs matmuls; ``score``, which keeps its cumsum, shows
    that the recorder sees one."""
    _, tspec = _specs("365d20e")
    problem = ts.make_scheduling_problem(tspec, proposer=proposer, n_rand_swaps=256)
    p = 2
    draws = TorchDraws("band", p, "cpu")
    assign = problem.init(draws)
    score = problem.score(assign)
    with _OpNames() as ops:
        nb = problem.neighborhood(assign, score, draws, torch.ones(p, dtype=torch.bool))
    assert nb.scores.shape == (p, problem.width, 2)
    assert not [name for name in ops.names if "cum" in name], ops.names
    assert ops.names["mm"] + ops.names["bmm"] > 0, ops.names
    with _OpNames() as score_ops:
        problem.score(assign)
    assert score_ops.names["cumsum"] > 0
