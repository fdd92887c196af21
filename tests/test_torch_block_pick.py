"""K3, the block pick (``ops/block_pick.py``), and the N-Queens row block it
reads, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2e).  What runs here:

- the plain version against the port's ``lex_argmin(make_score(...))`` and the
  JAX package's ``lex_argmin`` on the same seeded blocks of small integers
  (ties everywhere), with invalid rows, lanes with no valid row, and exclusion
  lists with -1 slots, repeats and hits on and off each row's first minimum;
- the kernel's algorithm (each row's first minimum, the rows whose minimum is
  excluded scanned again, as one flat space of items cut into S contiguous
  slices, one block of a cluster each, merged by the same fold) written out in
  torch, against the plain version for S = 1, 2, 3 and 8, also on floats with
  signed zeros, infinities and NaN, and on ties, a NaN, signed zeros and a
  fully excluded row placed across the slices' boundaries;
- the launch plan (``_launch_plan``): blocks a lane and threads a block;
- the N-Queens neighborhood's row block against the JAX neighborhood, and the
  descent's pick-then-check in the block form against the same problem with
  the block materialized, eagerly and through the graphed loop's segments,
  with retries forced by a large ring;
- that a pick-then-check iteration stacks no score block;
- the wrapper's checks, and the library's build (a faked compiler and
  ``ctypes``), K3's and K4's (``ops/nqueens_move.py``).
"""

import ctypes
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from constraint_solver_tpu.models import nqueens as jnq
from constraint_solver_tpu.ops.lex import lex_argmin as j_lex_argmin
from constraint_solver_tpu_torch.core import problem as core_problem
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import nqueens as tnq
from constraint_solver_tpu_torch.ops import block_pick as bp
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops import nqueens_move as nm
from constraint_solver_tpu_torch.ops.lex import lex_argmin, make_score
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.convert import from_reference
from constraint_solver_tpu_torch.utils.tree import tree_leaves
from jax_key_draws import JaxKeyDraws, reference_log_weights
from test_torch_graphs import Forced


def _row_stats(hard):
    return hard.amin(dim=-1), hard.argmin(dim=-1).to(torch.int32)


def _block(rng, p, r, c, high=4, invalid=0.25, dead_lanes=(0,)):
    """A row block of small integers (ties abound), its row stats and validity:
    about ``invalid`` of the rows invalid, every row of ``dead_lanes`` invalid."""
    hard = torch.from_numpy(rng.integers(0, high, size=(p, r, c)).astype(np.float32))
    row_valid = torch.from_numpy(rng.random((p, r)) >= invalid)
    for lane in dead_lanes:
        row_valid[lane] = False
    return hard, row_valid, *_row_stats(hard)


def _exclusions(rng, hard, row_valid, row_arg, e, share_on_arg=0.5):
    """[P, E] int64: -1 slots, repeats, and flat indices on and off the rows'
    first minima (of valid and invalid rows)."""
    p, r, c = hard.shape
    excl = np.full((p, e), -1, dtype=np.int64)
    for lane in range(p):
        for k in range(e):
            u = rng.random()
            j = int(rng.integers(0, r))
            if u < 0.2:
                continue  # an empty slot
            if u < 0.3 and k:
                excl[lane, k] = excl[lane, int(rng.integers(0, k))]  # a repeat (maybe of -1)
            elif u < 0.3 + 0.7 * share_on_arg:
                excl[lane, k] = j * c + int(row_arg[lane, j])  # a row's first minimum
            else:
                excl[lane, k] = j * c + int(rng.integers(0, c))
    return torch.from_numpy(excl)


def _port_chain(hard, row_valid, excl):
    """The engine's pick before K3, written out: the stacked block, the mask
    with each exclusion removed, ``lex_argmin``."""
    p, r, c = hard.shape
    w = r * c
    mask = row_valid.repeat_interleave(c, dim=1)
    iota = torch.arange(w)
    for k in range(excl.shape[1]):
        mask = mask & (iota != excl[:, k : k + 1])
    return lex_argmin(make_score(hard.reshape(p, w)), mask)


def _jax_pick(hard, row_valid, excl):
    p, r, c = hard.shape
    w = r * c
    valid = np.repeat(row_valid.numpy(), c, axis=1)
    mask = jnp.asarray(valid)
    iota = jnp.arange(w)
    for k in range(excl.shape[1]):
        mask = mask & (iota != jnp.asarray(excl[:, k : k + 1].numpy()))
    scores = jnp.stack([jnp.asarray(hard.reshape(p, w).numpy()), jnp.zeros((p, w), jnp.float32)], axis=-1)
    return np.asarray(j_lex_argmin(scores, mask))


_NO_INDEX = 2**63 - 1


def _fold(best, v, i):
    """The kernel's fold: (v, i) replaces the best when lower, or equal at a
    lower index (-0.0 ties 0.0)."""
    return (v, i) if v < best[0] or (v == best[0] and i < best[1]) else best


def _row_minimum_pick(hard, row_valid, row_min, row_arg, excl, slices=1):
    """The kernel's algorithm in torch: each valid row's (row_min, j·C +
    row_arg); the rows whose first minimum is excluded queued in row order and
    scanned again without their excluded entries, as one flat space of items
    (queued row, 4 columns; 1 where C % 4 != 0) cut into ``slices`` contiguous
    slices, one block each, block 0 also folding the rows' first minima; the
    blocks' (value, index, NaN flag) merged by the same fold; 0 where the
    minimum is +inf or a candidate is NaN."""
    p, r, c = hard.shape
    w = 4 if c % 4 == 0 else 1
    cw = c // w
    inf = float("inf")
    out = torch.zeros(p, dtype=torch.int64)
    for lane in range(p):
        ex = set(excl[lane].tolist()) if excl is not None else set()
        firsts, queued = [], []
        for j in range(r):
            if not bool(row_valid[lane, j]):
                continue
            flat = j * c + int(row_arg[lane, j])
            if flat in ex:
                queued.append(j)
            else:
                firsts.append((float(row_min[lane, j]), flat))
        total = len(queued) * cw
        best, nan = (inf, _NO_INDEX), False
        for b in range(slices):
            cands = list(firsts) if b == 0 else []
            for i in range(total * b // slices, total * (b + 1) // slices):
                q, k = divmod(i, cw)
                flat0 = queued[q] * c + k * w
                cands += [(float(hard[lane, queued[q], k * w + d]), flat0 + d) for d in range(w)
                          if flat0 + d not in ex]
            part = (inf, _NO_INDEX)
            for v, i in cands:
                if v != v:
                    nan = True
                else:
                    part = _fold(part, v, i)
            best = _fold(best, *part)
        out[lane] = best[1] if not nan and best[0] < inf else 0
    return out


SHAPES = pytest.mark.parametrize("p, r, c, e", [(6, 5, 7, 8), (5, 3, 16, 4), (4, 1, 9, 3), (3, 12, 2, 16),
                                                (7, 4, 5, 0)])


@SHAPES
def test_plain_version_equals_the_port_chain_and_jax(p, r, c, e):
    rng = np.random.default_rng(p * 1000 + r * 100 + c * 10 + e)
    hard, row_valid, row_min, row_arg = _block(rng, p, r, c)
    excl = _exclusions(rng, hard, row_valid, row_arg, e)
    got = bp.block_pick(hard, row_valid, row_min, row_arg, excl)
    assert got.dtype == torch.int64 and got.shape == (p,)
    assert torch.equal(got, bp.block_pick_ref(hard, row_valid, row_min, row_arg, excl))
    assert torch.equal(got, _port_chain(hard, row_valid, excl))
    np.testing.assert_array_equal(got.numpy(), _jax_pick(hard, row_valid, excl))
    assert int(got[0]) == 0  # a lane with no valid row
    if e == 0:
        assert torch.equal(got, bp.block_pick(hard, row_valid, row_min, row_arg))  # None: no exclusion


SLICES = pytest.mark.parametrize("slices", [1, 2, 3, 8])


@SLICES
@SHAPES
def test_row_minimum_algorithm_equals_the_plain_version(p, r, c, e, slices):
    rng = np.random.default_rng(7 + p * r * c + e)
    for high in (2, 4):  # mostly ties
        hard, row_valid, row_min, row_arg = _block(rng, p, r, c, high=high)
        excl = _exclusions(rng, hard, row_valid, row_arg, e, share_on_arg=0.8)
        want = bp.block_pick_ref(hard, row_valid, row_min, row_arg, excl)
        assert torch.equal(_row_minimum_pick(hard, row_valid, row_min, row_arg, excl, slices), want)
    # Every valid candidate excluded: 0.
    hard, row_valid, row_min, row_arg = _block(rng, 2, 2, 3, invalid=0.0, dead_lanes=())
    everything = torch.arange(6).expand(2, 6).contiguous()
    assert torch.equal(bp.block_pick(hard, row_valid, row_min, row_arg, everything), torch.zeros(2, dtype=torch.int64))


@SLICES
def test_row_minimum_algorithm_on_signed_zeros_infinities_and_nan(slices):
    """The precondition (row stats by ``amin`` and ``argmin``) carries the
    plain version's float semantics: -0.0 ties 0.0, a +inf minimum or a NaN
    candidate gives 0, -inf is a minimum like any other."""
    inf, nan = float("inf"), float("nan")
    rows = [
        [[3.0, -0.0, 0.0], [0.0, 5.0, -0.0]],
        [[inf, inf, inf], [inf, inf, inf]],
        [[2.0, nan, 1.0], [0.0, 0.0, 0.0]],
        [[4.0, -inf, 1.0], [-inf, 2.0, 2.0]],
        [[inf, 7.0, inf], [9.0, inf, 7.0]],
    ]
    hard = torch.tensor(rows, dtype=torch.float32)
    row_min, row_arg = _row_stats(hard)
    row_valid = torch.ones((5, 2), dtype=torch.bool)
    for excl in (None, torch.tensor([[1, 5], [0, -1], [1, -1], [1, 3], [1, -1]]),
                 torch.tensor([[-1, -1], [3, 4], [-1, 0], [-1, -1], [5, 1]])):
        want = bp.block_pick_ref(hard, row_valid, row_min, row_arg, excl)
        assert torch.equal(_row_minimum_pick(hard, row_valid, row_min, row_arg, excl, slices), want), excl


def _trap_block(trap):
    """(hard, row_valid, row_min, row_arg, excl) of 1-2 lanes whose answer
    depends on the slices' merge: 16 columns (4 items) a row, rows 1 and 3 (and
    5) queued, so their items fall into different slices for S > 1."""
    inf, nan = float("inf"), float("nan")
    c = 16
    base = [[5.0] * c for _ in range(6)]
    lanes, excls = [], []
    if trap == "ties":
        # 1.0 in row 1 at 0 (its first minimum, excluded), 5 and 9; row 3 at 0 and 2; row 4 at 0, not queued:
        # rank 0 holds row 4's (1.0, 64), later ranks lower indices.
        rows = [list(x) for x in base]
        for j, cols in ((1, (0, 5, 9)), (3, (0, 2)), (4, (0,))):
            for k in cols:
                rows[j][k] = 1.0
        lanes.append(rows)
        excls.append([1 * c, 3 * c, -1, -1, -1, -1, -1, -1])
        rows = [list(x) for x in base]  # the tie inside one queued row, across its items
        rows[3][0] = rows[3][7] = rows[3][12] = 0.5
        lanes.append(rows)
        excls.append([3 * c, 1 * c + 0, -1, -1, -1, -1, -1, -1])
    elif trap == "nan_last":
        rows = [list(x) for x in base]
        for j in (1, 3):
            rows[j][0] = 2.0
        rows[5][0] = rows[5][15] = nan  # the first excluded, the second in the last item
        lanes.append(rows)
        excls.append([1 * c, 3 * c, 5 * c, -1, -1, -1, -1, -1])
    elif trap == "signed_zeros":
        for first, second in ((-0.0, 0.0), (0.0, -0.0)):
            rows = [list(x) for x in base]
            rows[1][0], rows[1][14] = first, first
            rows[3][1], rows[3][2] = second, second
            lanes.append(rows)
            excls.append([1 * c, 3 * c + 1, -1, -1, -1, -1, -1, -1])
    else:  # "excluded_row": row 1 wholly excluded; in the second lane every valid row is
        rows = [list(x) for x in base]
        rows[1] = [0.0] * c
        rows[2][9] = 3.0
        lanes.append(rows)
        excls.append([1 * c + k for k in range(c)] + [-1] * 4)
        rows = [list(x) for x in base]
        lanes.append(rows)
        excls.append([2 * c + k for k in range(c)] + [1 * c + k for k in range(4)])
    hard = torch.tensor(lanes, dtype=torch.float32)
    row_min, row_arg = _row_stats(hard)
    row_valid = torch.ones(hard.shape[:2], dtype=torch.bool)
    if trap == "excluded_row":
        row_valid[1] = False
        row_valid[1, 2] = True
    excl = torch.tensor(excls, dtype=torch.int64)
    return hard, row_valid, row_min, row_arg, excl


@SLICES
@pytest.mark.parametrize("trap, want", [("ties", [21, 55]), ("nan_last", [0]), ("signed_zeros", [30, 30]),
                                        ("excluded_row", [41, 0])])
def test_row_minimum_algorithm_across_slice_boundaries(trap, want, slices):
    """Ties whose lowest index lies in a later block than rank 0's candidate,
    a NaN only in the last block's slice, -0.0 and 0.0 in different blocks,
    a queued row with every entry excluded: the merged pick is the plain
    version's for every S."""
    args = _trap_block(trap)
    got = _row_minimum_pick(*args, slices)
    assert torch.equal(bp.block_pick_ref(*args), torch.tensor(want)), trap
    assert torch.equal(got, torch.tensor(want)), (trap, slices, got)


@pytest.mark.parametrize("p, slices", [(1, 8), (16, 8), (64, 4), (256, 1), (300, 1)])
def test_launch_plan_spreads_few_lanes_over_a_cluster(p, slices):
    """S: the smallest power of two with P·S ≥ the SMs, at most 8; P·S blocks
    of 256 threads a retry; a first pick one block of 128 a lane; a short row
    (too few items of one row for a second block) S = 1, whatever R and E."""
    plan = bp._launch_plan(p, 64, 16384, 8, 132)
    assert plan == bp.LaunchPlan(slices, bp.RETRY_THREADS, p * slices)
    assert bp._launch_plan(p, 64, 16384, 0, 132) == bp.LaunchPlan(1, bp.PICK_THREADS, p)
    for r, c, e in ((50, 1000, 8), (3, 64, 8), (12, 2, 16), (64, 16384, 256), (64, 4099, 1), (64, 2048, 8)):
        s = bp._launch_plan(p, r, c, e, 132).slices
        assert s in (1, 2, 4, 8) and (s == 1 or p * s // 2 < 132)
        assert s == 1 or -(-c // 4) >= s * bp.RETRY_THREADS  # a block's share of one row: 256 items or more
        assert all(bp._launch_plan(p, r2, c, e2, 132).slices == s for r2, e2 in ((1, 1), (r, 256)))
    assert bp._launch_plan(p, 64, 1000, 8, 132).slices == 1  # 250 items a row: one block
    assert bp._launch_plan(p, 64, 16384, 8, 114).slices == {64: 2}.get(p, slices)  # an H100 PCIe's 114 SMs


def _jax_state(boards):
    rows = jnp.asarray(boards)
    return jax.vmap(jnq.build_state)(rows)


def test_nqueens_row_block_matches_the_jax_neighborhood():
    """The block form's materialized scores and mask, its ``n_valid``, and its
    ``hint_idx`` against the JAX neighborhood; a solved lane has no valid
    column, and its ``hint_idx`` is ``lex_argmin``'s 0 (the JAX package's
    row-minimum form gives its ``row_arg[0]``; no such pick is taken)."""
    n, a, p = 20, 4, 5
    rng = np.random.default_rng(20)
    boards = rng.integers(0, n, size=(p, n)).astype(np.int32)
    boards[3] = [0, 2, 4, 1, 3, 12, 14, 11, 17, 19, 16, 8, 15, 18, 7, 9, 6, 13, 5, 10]  # a solution of 20 queens
    jp = jnq.make_nqueens_problem(n, sample_cols=a)
    tp = tnq.make_nqueens_problem(n, sample_cols=a, log_weights=reference_log_weights(n))
    jst = _jax_state(boards)
    keys = jax.random.split(jax.random.key(n), p)
    nb_j = jax.jit(jax.vmap(jp.neighborhood))(jst, jax.vmap(jp.score)(jst), jax.vmap(jax.random.split)(keys)[:, 1])
    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    tst = from_reference(jst, "cpu")
    nb_t = tp.neighborhood(tst, tp.score(tst), draws, torch.ones(p, dtype=torch.bool))
    assert nb_t.scores is None and nb_t.valid is None and nb_t.block.hard.shape == (p, a, n)
    np.testing.assert_array_equal(nb_t.all_scores().numpy(), np.asarray(nb_j.scores))
    np.testing.assert_array_equal(nb_t.all_valid().numpy(), np.asarray(nb_j.valid))
    np.testing.assert_array_equal(nb_t.n_valid.numpy(), np.asarray(nb_j.n_valid))
    solved = nb_t.n_valid == 0
    assert solved.tolist() == [False, False, False, True, False]
    hint_j = np.asarray(nb_j.hint_idx)
    np.testing.assert_array_equal(nb_t.hint_idx[~solved].numpy(), hint_j[~solved.numpy()])
    assert int(nb_t.hint_idx[3]) == 0 and hint_j[3] == int(nb_t.block.row_arg[3, 0])
    assert torch.equal(nb_t.hint_idx, lex_argmin(nb_t.all_scores(), nb_t.all_valid()))
    idx = torch.from_numpy(rng.integers(0, a * n, size=p))
    lane = torch.arange(p)
    assert torch.equal(nb_t.score_at(idx), nb_t.all_scores()[lane, idx])


def _materialized(problem):
    """``problem`` whose neighborhood hands the engine the block built whole:
    the form every other domain uses."""
    inner = problem.neighborhood

    def neighborhood(*args):
        nb = inner(*args)
        if nb is None or nb.block is None:
            return nb
        return nb._replace(scores=nb.all_scores(), valid=nb.all_valid(), block=None)

    return problem._replace(neighborhood=neighborhood)


@pytest.mark.parametrize("loop", ["eager", "graphed"])
def test_pick_then_check_in_the_block_form_equals_the_block_materialized(loop, monkeypatch):
    """A descent's picks by K3's plain version from the row block against the
    same problem with the block materialized, over a ring large enough to
    force retries: traces, state trees and stats bit for bit, eagerly and
    through the graphed loop's segments (``Forced(capturer=None)``)."""
    retries = []
    pick = core_problem.block_pick
    monkeypatch.setattr(core_problem, "block_pick",
                        lambda *a: retries.append(a[-1] is not None) or pick(*a))
    config = SolverConfig(seed="k3-retries", local_search_max_iterations=30, best_solutions_capacity=4,
                          all_solutions_capacity=256, restart_every=4, tabu_exact_filter=False)
    problem = tnq.make_nqueens_problem(10, sample_cols=2)
    out = []
    for prob in (problem, _materialized(problem)):
        s = PopulationSolver(prob, config, population=6, exchange_every=2, device="cpu")
        if loop == "graphed":
            s.program = dataclasses.replace(s.program, graphs=Forced(capturer=None))
        out.append(([s.execute_chunk_traced(2) for _ in range(2)], s.state, s.stats()))
    (traces, state, stats), (traces0, state0, stats0) = out
    for t, t0 in zip(traces, traces0, strict=True):
        np.testing.assert_array_equal(t, t0)
    for x, y in zip(tree_leaves(state), tree_leaves(state0), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert stats == stats0
    assert sum(retries) > 0  # retries ran, each a block pick with the exclusion list


class Joins(TorchDispatchMode):
    """Records the elements of every tensor an ``aten::stack`` or ``aten::cat``
    writes (the profiler records no shapes of a tensor list)."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.stack, torch.ops.aten.cat):
            self.sizes.append(out.numel())
        return out


def test_a_pick_then_check_iteration_stacks_no_score_block(monkeypatch):
    """Without ``nbr_axis`` or the exact filter, the neighborhood and the
    descent stack no [P, A·n, 2] block: no ``aten::stack``/``aten::cat`` of
    A·n·2 elements a lane in a descent with retries.  K3's plain version, which
    the card does not run, stands aside for the kernel's algorithm in torch.
    The same descent with the block materialized does stack it."""
    retries = []

    def row_minimum_pick(hard, row_valid, row_min, row_arg, excl=None):
        retries.append(excl is not None)
        return _row_minimum_pick(hard, row_valid, row_min, row_arg, excl)

    monkeypatch.setattr(bp, "block_pick_ref", row_minimum_pick)
    n, a, p = 10, 2, 4
    config = SolverConfig(seed="k3-retries", local_search_max_iterations=12, best_solutions_capacity=4,
                          all_solutions_capacity=128, tabu_exact_filter=False)
    problem = tnq.make_nqueens_problem(n, sample_cols=a)
    largest = []
    for prob in (problem, _materialized(problem)):
        s = PopulationSolver(prob, config, population=p, device="cpu")
        with Joins() as joins:
            s.run(max_rounds=1, chunk=1)
        assert s.stats()["ls_iterations"] > 0
        largest.append(max(joins.sizes))
    assert sum(retries) > 0
    assert largest[0] < p * a * n * 2 <= largest[1], largest


def test_wrapper_checks_its_inputs():
    rng = np.random.default_rng(1)
    hard, row_valid, row_min, row_arg = _block(rng, 3, 4, 5)
    excl = torch.full((3, 2), -1, dtype=torch.int64)
    with pytest.raises(TypeError):
        bp.block_pick(hard.double(), row_valid, row_min, row_arg, excl)
    with pytest.raises(TypeError):
        bp.block_pick(hard, row_valid, row_min, row_arg.long(), excl)
    with pytest.raises(TypeError):
        bp.block_pick(hard, row_valid, row_min, row_arg, excl.int())
    with pytest.raises(ValueError):
        bp.block_pick(hard.transpose(1, 2).contiguous().transpose(1, 2), row_valid, row_min, row_arg, excl)
    with pytest.raises(ValueError):
        bp.block_pick(hard, row_valid[:2], row_min, row_arg, excl)
    with pytest.raises(ValueError):
        bp.block_pick(hard[0], row_valid, row_min, row_arg, excl)
    with pytest.raises(ValueError, match="no candidate"):
        bp.block_pick(hard[:, :, :0], row_valid, row_min, row_arg, excl)
    with pytest.raises(ValueError, match="at most 256"):
        bp.block_pick(hard, row_valid, row_min, row_arg, torch.full((3, 257), -1, dtype=torch.int64))
    for slices, x in ((0, excl), (9, excl), (2, None)):
        with pytest.raises(ValueError, match="_slices"):
            bp.block_pick(hard, row_valid, row_min, row_arg, x, _slices=slices)
    before = bp.block_pick.launches
    bp.block_pick(hard, row_valid, row_min, row_arg, excl)
    assert bp.block_pick.launches == before  # no kernel on the CPU


def test_kernel_work_counts_the_row_pass_and_the_rescans():
    assert bp.kernel_work(256, 50, 1000, 0) == (256 * 50, 9 * 256 * 50 + 8 * 256)
    ops, nbytes = bp.kernel_work(16, 64, 16384, 8)
    assert nbytes == 9 * 16 * 64 + 8 * 16 * 8 + 4 * 16 * 8 * 16384 + 8 * 16
    assert ops == (16 * 64 + 16 * 8 * 16384) * 9
    assert bp.kernel_work(16, 64, 16384, 8, rescanned=3)[1] == 9 * 16 * 64 + 8 * 16 * 8 + 4 * 3 * 16384 + 8 * 16
    assert bp.kernel_work(2, 3, 10, 8)[1] == 9 * 6 + 8 * 16 + 4 * 6 * 10 + 16  # at most R rows a lane


def test_roofline_counts_k3_by_formula():
    from constraint_solver_tpu_torch.utils import roofline

    rng = np.random.default_rng(2)
    hard, row_valid, row_min, row_arg = _block(rng, 3, 4, 5)
    excl = torch.full((3, 2), -1, dtype=torch.int64)
    with roofline.counting() as count:
        bp.block_pick(hard, row_valid, row_min, row_arg, excl)
    ops, nbytes = bp.kernel_work(3, 4, 5, 2)
    assert dict(count.kernels[bp.KERNEL_NAME]) == {"calls": 1, "flops": ops, "bytes": nbytes}
    assert (count.flops, count.bytes) == (ops, nbytes)


# Each hand-written kernel's library built through a faked ``nvcc``: (its
# module, its C entry, the constants its source shares with the module).
BUILDS = {
    "block_pick": (bp, "block_pick_launch", {"kMaxExcl": bp.MAX_EXCL, "kPickThreads": bp.PICK_THREADS,
                                              "kRetryThreads": bp.RETRY_THREADS, "kMaxSlices": bp.MAX_SLICES}),
    "nqueens_move": (nm, "nqueens_move_launch", {"kColumns": nm.COLUMNS, "kMaxThreads": nm.MAX_THREADS,
                                                  "kMaxSlices": nm.MAX_SLICES}),
}


@pytest.fixture(params=sorted(BUILDS))
def fake_toolchain(request, tmp_path, monkeypatch):
    mod, entry, consts = BUILDS[request.param]
    compiled, loaded = [], []

    def run(cmd, **kwargs):
        compiled.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return nk.subprocess.CompletedProcess(cmd, 0, "", "")

    class Library:
        def __init__(self, path):
            loaded.append(path)
            setattr(self, entry, type("Entry", (), {})())

    monkeypatch.setattr(nk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nk.subprocess, "run", run)
    monkeypatch.setattr(nk.ctypes, "CDLL", Library)
    monkeypatch.setattr(mod, "_LIBRARY", nk.KernelLibrary(mod._SRC, tmp_path / mod._LIB_PATH.name,
                                                          mod._LIBRARY.argtypes))
    return mod, entry, consts, compiled, loaded


def test_the_library_builds_once_with_the_c_entry_it_declares(fake_toolchain):
    mod, entry, want, compiled, loaded = fake_toolchain
    fn = mod._LIBRARY.entry(entry)
    assert mod._LIBRARY.entry(entry) is fn and len(compiled) == len(loaded) == 1
    cmd = compiled[0]
    assert cmd[-1] == str(mod._SRC) and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1].startswith(str(mod._LIBRARY.lib) + f".{os.getpid()}.")
    assert fn.restype is ctypes.c_int
    src = mod._SRC.read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    kinds = [ctypes.c_void_p if "*" in q else ctypes.c_int for q in params.split(",")]
    assert fn.argtypes == kinds == mod._ARGS
    assert mod._LIB_PATH == nk._BUILD_DIR / f"lib{mod.KERNEL_NAME}.so"
    consts = {name: int(re.search(rf"{name} = (\d+);", src).group(1)) for name in want}
    assert consts == want


def test_a_failed_build_raises(fake_toolchain, monkeypatch):
    mod, entry = fake_toolchain[:2]
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 2, "", "error: no sm_90a"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        mod._LIBRARY.entry(entry)
    assert mod._LIBRARY.entries is None
