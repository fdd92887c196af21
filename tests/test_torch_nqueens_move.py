"""K4, the masked N-Queens move (``ops/nqueens_move.py``), and the N-Queens
descent that writes its move in place and carries its best as the board
(``Problem.in_place``; ``models/nqueens.py``, ``core/local_search.py``).

The JAX package selects whole state trees per lane.  With the field every
output must stay bit for bit the select form's: the masked move against
``apply_move`` followed by the select, and a descent with the field against
the same problem with it stripped and against the JAX ``ls_execute``, eagerly
and through the graphed loop's static carry.  Float tensors are compared by
their bits, so a -0 for a +0 fails too.  The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2f); here the wrapper
takes the plain version.  Its build is tested with a faked compiler beside
K3's (``tests/test_torch_block_pick.py``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core import history as jh
from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.core.local_search import ls_execute as j_ls_execute
from constraint_solver_tpu.models.nqueens import build_state as j_build_state
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_make
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.core.local_search import ls_execute
from constraint_solver_tpu_torch.models import nqueens as tnq
from constraint_solver_tpu_torch.ops import nqueens_move as nm
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from constraint_solver_tpu_torch.utils.tree import tree_leaves, tree_map, tree_where
from jax_key_draws import JaxKeyDraws, reference_log_weights
from test_torch_engine import assert_tree_equal
from test_torch_graphs import Forced

STRIPPED = dict(in_place=None)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bits_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _state(rng, p, n):
    """Counters of random boards (queens may share rows: many conflicts)."""
    return tnq.build_state(torch.from_numpy(rng.integers(0, n, size=(p, n))))


def _moves(rng, p, n, a):
    """A row-strided [P, A] view of distinct columns per lane, as the
    neighborhood's sample is, with column 0 and column n-1 in every lane."""
    full = torch.from_numpy(np.stack([np.r_[0, n - 1, rng.permutation(np.arange(1, n - 1))] for _ in range(p)]))
    return tnq.NQMoves(full[:, :a], n)


def _picks(rng, st, moves):
    """Flat moves of 8 lanes: column 0 to row 0, column n-1 to row n-1,
    column 0 to row n-1, column n-1 to row 0, a same-row move (lane 4), and
    three random moves."""
    a, n = moves.cols.shape[1], moves.n
    same = int(st.rows[4, int(moves.cols[4, 2])])  # r_old == r_new
    k = [0, 1, 0, 1, 2, 2, 3, rng.integers(0, a)]
    r = [0, n - 1, n - 1, 0, same, rng.integers(0, n), rng.integers(0, n), rng.integers(0, n)]
    return torch.tensor([int(ki) * n + int(ri) for ki, ri in zip(k, r, strict=True)])


@pytest.mark.parametrize("mask", ["all", "none", "mixed", "one"])
@pytest.mark.parametrize("n", [5, 23, 64])
def test_masked_move_equals_move_then_select(n, mask):
    """In the lanes of the mask the move's rows, counters and column scores
    equal ``apply_move``'s and a rebuild from the moved board; in the others
    the old tensors, bit for bit (a -0 there too); the buffers are the
    state's own and the call returns None."""
    p, a = 8, min(n, 4)
    rng = np.random.default_rng(n)
    problem = tnq.make_nqueens_problem(n, sample_cols=a)
    st = _state(rng, p, n)
    moves = _moves(rng, p, n, a)
    idx = _picks(rng, st, moves)
    on = {"all": [True] * p, "none": [False] * p, "mixed": [True, False] * 4, "one": [False] * 7 + [True]}[mask]
    on = torch.tensor(on)
    if not on[1]:
        st.cs[1, 0] = -0.0  # a lane the mask leaves alone keeps its signed zeros

    old = tree_map(torch.clone, st)
    want = tree_where(on, problem.apply_move(old, moves, idx), old)
    buffers = list(st)
    assert problem.in_place.move is nm.nqueens_move
    assert problem.in_place.move(st, moves, idx, on) is None
    assert all(x is y for x, y in zip(st, buffers))
    assert_bits_equal(st, want)
    for k in range(p):
        if on[k]:
            assert_bits_equal(tnq.NQState(*(x[k : k + 1] for x in st)), tnq.build_state(st.rows[k : k + 1]))
    assert_bits_equal(tnq.NQState(*(x[4] for x in st)), tnq.NQState(*(x[4] for x in old)))  # a same-row move


def test_masked_move_equals_the_jax_move():
    """The JAX package's ``apply_move`` on each lane, vmapped, equals the
    masked move with every lane on."""
    n, p, a = 20, 8, 4
    rng = np.random.default_rng(7)
    jp = j_make(n, sample_cols=a)
    st = _state(rng, p, n)
    moves = _moves(rng, p, n, a)
    idx = _picks(rng, st, moves)
    cols = moves.cols.gather(1, idx[:, None] // n)[:, 0]
    jst = jax.vmap(j_build_state)(jnp.asarray(st.rows.numpy(), jnp.int32))
    pairs = (jnp.asarray(cols.numpy()[:, None], jnp.int32), jnp.asarray((idx % n).numpy()[:, None], jnp.int32))
    want = jax.jit(jax.vmap(jp.apply_move))(jst, pairs, jnp.zeros(p, jnp.int32))
    nm.nqueens_move(st, moves, idx, torch.ones(p, dtype=torch.bool))
    assert_tree_equal(want, to_reference(st), "moved")


def test_best_key_rebuilds_the_state():
    rng = np.random.default_rng(2)
    problem = tnq.make_nqueens_problem(16)
    st = _state(rng, 4, 16)
    key = problem.in_place.key(st)
    assert key is st.rows
    assert_bits_equal(problem.in_place.rebuild(key), st)


def test_the_factory_sets_the_field_without_nbr_axis_only():
    assert tnq.make_nqueens_problem(16).in_place is not None
    for kw in ({"block_impl": "mxu_conv"}, {"sample_cols": 3}, {"use_pallas": True}):
        assert tnq.make_nqueens_problem(16, **kw).in_place is not None
    sharded = tnq.make_nqueens_problem(16, nbr_axis="nbr", nbr_shards=2)
    assert sharded.in_place is None and sharded.capturable is False


def _config(**kw):
    base = dict(seed="5", local_search_max_iterations=14, best_solutions_capacity=3, all_solutions_capacity=16,
                all_solution_iteration_expiry=30, restart_every=3)
    base.update(kw)
    return base


_DESCENT = (24, 6)  # n, P


@functools.lru_cache(maxsize=2)
def _jax_descent(exact):
    """The JAX ``ls_execute`` of ``_DESCENT``'s lanes, vmapped: (start, ring,
    keys, enabled, its outputs), once per tabu mode for both loops."""
    n, p = _DESCENT
    rng = np.random.default_rng(11)
    jp = j_make(n)
    jparams = JConfig(**_config(tabu_exact_filter=exact)).ls_params(jp.width)
    boards = rng.integers(0, n, size=(p, n))
    boards[4] = np.r_[np.arange(1, n, 2), np.arange(0, n, 2)]  # a solution for n % 6 in (0, 4)
    assert int(tnq.total_conflicts(torch.from_numpy(boards[4]))) == 0
    jstart = jax.vmap(j_build_state)(jnp.asarray(boards, jnp.int32))
    descend = jax.jit(jax.vmap(lambda s, t, k, e: j_ls_execute(jp, jparams, s, t, k, e)))
    # A first descent fills the ring with the states around the start, so the
    # compared second descent from the same start meets tabu candidates.
    jring = jax.vmap(lambda _: jh.TabuRing.create(16, 30))(jnp.arange(p))
    jring = descend(jstart, jring, jax.random.split(jax.random.key(-n), p), jnp.ones(p, bool))[2]
    keys = jax.random.split(jax.random.key(n), p)
    enabled = np.array([True, True, False, True, True, True])
    return jstart, jring, keys, enabled, descend(jstart, jring, keys, jnp.asarray(enabled))


@pytest.mark.parametrize("loop", ["eager", "graphed"])
@pytest.mark.parametrize("exact", [None, False], ids=["exact-filter", "pick-then-check"])
def test_descent_with_the_field_equals_the_select_form_and_jax(exact, loop):
    """``ls_execute`` from the same JAX keys, with the field, with it stripped
    and in the JAX package: best state, best score, tabu ring, iterations and
    exhaustion bit for bit; one lane disabled, one whose start is a solution
    (``is_best`` stops it at once: its best is the state it stopped at);
    ``start_state`` left as it was.  ``graphed``: the static-carry loop of
    ``core/graphed.py`` with its segments run eagerly; its carry's state too."""
    n, p = _DESCENT
    tp = tnq.make_nqueens_problem(n, log_weights=reference_log_weights(n))
    tparams = SolverConfig(**_config(tabu_exact_filter=exact)).ls_params(tp.width)
    assert tparams.tabu_exact_filter == (exact is None)
    jstart, jring, keys, enabled, want = _jax_descent(exact)
    start = from_reference(jstart, "cpu")
    before = tree_map(torch.clone, start)
    runs, carries = [], []
    for problem in (tp, tp._replace(**STRIPPED)):
        draws = JaxKeyDraws(keys)
        draws._ls_key = keys
        graphs = Forced(capturer=None) if loop == "graphed" else None
        runs.append(ls_execute(problem, tparams, start, from_reference(jring, "cpu"), draws,
                               torch.from_numpy(enabled), graphs=graphs))
        assert_bits_equal(start, before)
        if graphs is not None:
            (unit,) = graphs._units.values()
            carries.append(unit.carry.state)
    got, stripped = runs
    assert_bits_equal(got, stripped)
    if carries:
        assert_bits_equal(*carries)
    assert_tree_equal(want[0], to_reference(got[0]), "best_state")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_tree_equal(want[2], to_reference(got[2]), "tabu")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(got[3][2]) == 0 and int(got[3].max()) > 2
    assert float(got[1][4, 0]) == 0.0  # the solved lane stopped at its start
    assert_bits_equal(tnq.NQState(*(x[4] for x in got[0])), tnq.NQState(*(x[4] for x in start)))


@pytest.mark.parametrize("loop", ["eager", "graphed"])
def test_population_solve_with_the_field_equals_the_select_form(loop):
    """Three rounds of a ``PopulationSolver`` with the field and with it
    stripped: traces, state trees (elite archive, tabu rings, counters) and
    ``stats()`` equal; the carried counters are their boards' rebuild."""
    config = SolverConfig(seed="nq-inplace", local_search_max_iterations=12, best_solutions_capacity=4,
                          all_solutions_capacity=32, restart_every=3, max_allow_no_improvement_for=4)
    problem = tnq.make_nqueens_problem(32)
    out = []
    for prob in (problem, problem._replace(**STRIPPED)):
        s = PopulationSolver(prob, config, population=4, exchange_every=2, device="cpu")
        if loop == "graphed":
            s.program = dataclasses.replace(s.program, graphs=Forced(capturer=None))
        out.append((s.execute_chunk_traced(3), s.state, s.stats()))
    (trace, state, stats), (trace0, state0, stats0) = out
    np.testing.assert_array_equal(trace, trace0)
    assert_bits_equal(state, state0)
    assert stats == stats0 and stats["rounds"] == 3 and stats["ls_iterations"] > 0
    assert_bits_equal(state.current_state, tnq.build_state(state.current_state.rows))


def test_wrapper_checks_its_inputs():
    rng = np.random.default_rng(1)
    p, n, a = 3, 6, 2
    st = _state(rng, p, n)
    moves = _moves(rng, p, n, a)
    idx, mask = torch.zeros(p, dtype=torch.int64), torch.ones(p, dtype=torch.bool)
    with pytest.raises(TypeError):
        nm.nqueens_move(st._replace(rows=st.rows.int()), moves, idx, mask)
    with pytest.raises(TypeError):
        nm.nqueens_move(st._replace(cs=st.cs.double()), moves, idx, mask)
    with pytest.raises(TypeError):
        nm.nqueens_move(st, moves, idx.int(), mask)
    with pytest.raises(TypeError):
        nm.nqueens_move(st, moves, idx, mask.int())
    with pytest.raises(TypeError):
        nm.nqueens_move(st, moves._replace(cols=moves.cols.int()), idx, mask)
    with pytest.raises(ValueError):
        nm.nqueens_move(st._replace(dc=st.dc[:, :-1]), moves, idx, mask)
    with pytest.raises(ValueError):
        nm.nqueens_move(st._replace(rc=st.rc.t().contiguous().t()), moves, idx, mask)
    with pytest.raises(ValueError):
        nm.nqueens_move(st, moves, idx[:2], mask)
    with pytest.raises(ValueError):
        nm.nqueens_move(st, moves._replace(n=n + 1), idx, mask)
    with pytest.raises(ValueError):
        nm.nqueens_move(st, moves._replace(cols=moves.cols.t().contiguous().t()), idx, mask)  # columns strided
    with pytest.raises(ValueError):
        nm.nqueens_move(st, moves._replace(cols=moves.cols[:, :0]), idx, mask)
    with pytest.raises(ValueError, match="at most"):
        nm.nqueens_move(st, moves._replace(n=nm.MAX_N + 1), idx, mask)
    before = tree_map(torch.clone, st)
    nm.nqueens_move(st, moves, idx, torch.zeros(p, dtype=torch.bool))
    assert_bits_equal(st, before)
    launches = nm.nqueens_move.launches
    nm.nqueens_move(st, moves, idx, mask)
    assert nm.nqueens_move.launches == launches  # no kernel on the CPU


def test_launch_plan_and_kernel_work():
    assert [nm._launch_plan(n) for n in (1, 1000, 1024, 1025, 2048, 4097, 16384, 16385, 10**6)] == [
        64, 64, 64, 128, 128, 512, 1024, 1024, 1024]
    assert nm.kernel_work(256, 1000) == (13 * 256 * 1000, 9 * 256 + 256 * (8 * 1000 + 68))
    assert nm.kernel_work(16, 16384, masked=3, changed=11) == (
        13 * 3 * 16384 + 11, 9 * 16 + 3 * (8 * 16384 + 68) + 8 * 11)
    assert nm.kernel_work(4, 10, masked=0) == (0, 36)


def test_move_work_counts_the_scores_the_moves_change():
    """``move_work`` counts the masked lanes and, off each moved column, the
    column scores that the plain version changes: no more, no fewer."""
    rng = np.random.default_rng(5)
    p, n, a = 8, 23, 4
    st = _state(rng, p, n)
    moves = _moves(rng, p, n, a)
    idx = torch.as_tensor(rng.integers(0, a * n, size=p))
    mask = torch.as_tensor(rng.random(p) < 0.6)
    mask[0] = True
    idx[0] = idx[0] // n * n + st.rows[0, moves.cols[0, idx[0] // n]]  # a same-row move changes nothing
    got = tree_map(torch.clone, st)
    nm.nqueens_move_ref(got, moves, idx, mask)
    lane = torch.arange(p)
    col = moves.cols[lane, idx // n]
    off_col = torch.ones(p, n, dtype=torch.bool)
    off_col[lane, col] = False
    changed = int(((got.cs != st.cs) & off_col).sum())
    assert changed > 0
    assert nm.move_work(st, moves, idx, mask) == nm.kernel_work(p, n, int(mask.sum()), changed)


def test_roofline_counts_k4_by_formula():
    """Counted by ``kernel_work`` on this call's data (``move_work``)."""
    from constraint_solver_tpu_torch.utils import roofline

    rng = np.random.default_rng(2)
    st = _state(rng, 3, 9)
    moves = _moves(rng, 3, 9, 2)
    idx, mask = torch.tensor([0, 5, 17]), torch.tensor([True, False, True])
    ops, nbytes = nm.move_work(st, moves, idx, mask)
    assert nbytes < nm.kernel_work(3, 9)[1]
    with roofline.counting() as count:
        nm.nqueens_move(st, moves, idx, mask)
    assert dict(count.kernels[nm.KERNEL_NAME]) == {"calls": 1, "flops": ops, "bytes": nbytes}
    assert (count.flops, count.bytes) == (ops, nbytes)


def test_the_smoke_timing_rotation_moves_each_copy_there_and_back(monkeypatch):
    """``chip_smoke.py`` phase 2f times K4 over state copies that do not fit
    the L2: each call moves the next copy, forward on one pass and back on the
    next, so every call does the same work and a cycle restores every copy."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "L2_BYTES", 1000)  # a few copies of a small state
    rng = np.random.default_rng(8)
    p, n, a = 4, 11, 3
    st = _state(rng, p, n)
    moves = _moves(rng, p, n, a)
    idx = torch.as_tensor(rng.integers(0, a * n, size=p))
    mask = torch.tensor([True, True, False, True])
    copies, call = chip_smoke.k4_rotation(st, moves, idx, mask)
    assert len(copies) == -(-chip_smoke.K4_L2_SPAN * 1000 // (st.rows.nbytes + st.cs.nbytes))
    works = []

    def move(state, moves, idx, mask):
        works.append(nm.move_work(state, moves, idx, mask))
        nm.nqueens_move(state, moves, idx, mask)

    for _ in range(len(copies)):
        call(move)
    want = tree_map(torch.clone, st)
    nm.nqueens_move_ref(want, moves, idx, mask)
    assert all(chip_smoke.k4_equal(c, want) for c in copies)
    for _ in range(len(copies)):
        call(move)
    assert all(chip_smoke.k4_equal(c, st) for c in copies)
    assert len(set(works)) == 1 and works[0][1] > nm.kernel_work(p, n, 3)[1]
