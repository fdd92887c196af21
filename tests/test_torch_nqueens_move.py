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
from constraint_solver_tpu.core.local_search import _select as j_select
from constraint_solver_tpu.core.local_search import ls_execute as j_ls_execute
from constraint_solver_tpu.models.nqueens import build_state as j_build_state
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_make
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.core.history import TabuRing
from constraint_solver_tpu_torch.core.local_search import ls_execute
from constraint_solver_tpu_torch.models import nqueens as tnq
from constraint_solver_tpu_torch.ops import nqueens_move as nm
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from constraint_solver_tpu_torch.utils.draws import TorchDraws
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


def _jax_moved(n, a, st, moves, idx):
    """The JAX package's ``apply_move`` of each lane's pick, vmapped."""
    jp = j_make(n, sample_cols=a)
    cols = moves.cols.gather(1, idx[:, None] // n)[:, 0]
    jst = jax.vmap(j_build_state)(jnp.asarray(st.rows.numpy(), jnp.int32))
    pairs = (jnp.asarray(cols.numpy()[:, None], jnp.int32), jnp.asarray((idx % n).numpy()[:, None], jnp.int32))
    return jst, jax.jit(jax.vmap(jp.apply_move))(jst, pairs, jnp.zeros(len(idx), jnp.int32))


@pytest.mark.parametrize("saving", ["no best", "best"])
@pytest.mark.parametrize("mask", ["all", "none", "mixed", "one"])
@pytest.mark.parametrize("n", [5, 23, 64])
def test_masked_move_equals_move_then_select(n, mask, saving):
    """In the lanes of the mask the move's rows, counters and column scores
    equal ``apply_move``'s and a rebuild from the moved board; in the others
    the old tensors, bit for bit (a -0 there too); the buffers are the
    state's own and the call returns None.  ``best``: the best board carried
    by the move equals the JAX package's ``apply_move`` followed by the
    descent's two ``_select``s (the moved board in the lanes of the mask, the
    old one in the others, then the old best outside ``save``), with lanes
    that move and save, move only, save only (a hit lane) and do neither."""
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
    kw = {}
    if saving == "best":
        best = torch.from_numpy(rng.integers(0, n, size=(p, n)))
        kw = dict(best=best, save=torch.tensor([True, True, False, False] * 2))

    old = tree_map(torch.clone, st)
    old_best = kw["best"].clone() if kw else None
    want = tree_where(on, problem.apply_move(old, moves, idx), old)
    buffers = list(st) + list(kw.values())
    assert problem.in_place.move is nm.nqueens_move and problem.in_place.saves_best
    assert problem.in_place.move(st, moves, idx, on, **kw) is None
    assert all(x is y for x, y in zip(list(st) + list(kw.values()), buffers))
    assert_bits_equal(st, want)
    if kw:
        jst, moved = _jax_moved(n, a, old, moves, idx)
        select = jax.vmap(j_select)
        j_on, j_save = jnp.asarray(on.numpy()), jnp.asarray(kw["save"].numpy())
        j_best = select(j_save, select(j_on, moved.rows, jst.rows), jnp.asarray(old_best.numpy(), jnp.int32))
        np.testing.assert_array_equal(kw["best"].numpy(), np.asarray(j_best))
        assert torch.equal(kw["best"], torch.where(kw["save"][:, None], st.rows, old_best))
    for k in range(p):
        if on[k]:
            assert_bits_equal(tnq.NQState(*(x[k : k + 1] for x in st)), tnq.build_state(st.rows[k : k + 1]))
    assert_bits_equal(tnq.NQState(*(x[4] for x in st)), tnq.NQState(*(x[4] for x in old)))  # a same-row move


def test_masked_move_equals_the_jax_move():
    """The JAX package's ``apply_move`` on each lane, vmapped, equals the
    masked move with every lane on."""
    n, p, a = 20, 8, 4
    rng = np.random.default_rng(7)
    st = _state(rng, p, n)
    moves = _moves(rng, p, n, a)
    idx = _picks(rng, st, moves)
    want = _jax_moved(n, a, st, moves, idx)[1]
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


def test_eager_descent_leaves_start_state_untouched():
    """The move writes the carry's state and its best board in place; the
    eager ``ls_execute`` copies both from ``start_state`` (whose board is the
    best's first key), so ``start_state`` stays bit for bit as it was and the
    best returned is a buffer of its own, though most lanes improve."""
    n, p = 32, 4
    problem = tnq.make_nqueens_problem(n)
    params = SolverConfig(**_config()).ls_params(problem.width)
    start = _state(np.random.default_rng(3), p, n)
    before = tree_map(torch.clone, start)
    best, best_score, *_ = ls_execute(problem, params, start, TabuRing.create(p, 16, 30, "cpu"),
                                      TorchDraws("untouched", p, "cpu"), torch.ones(p, dtype=torch.bool))
    assert_bits_equal(start, before)
    assert best.rows.untyped_storage().data_ptr() != start.rows.untyped_storage().data_ptr()
    assert int((best_score[:, 0] < problem.score(start)[:, 0]).sum()) >= p // 2
    assert_bits_equal(best, tnq.build_state(best.rows))


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
    best, save = st.rows.clone(), mask.clone()
    with pytest.raises(ValueError, match="together"):
        nm.nqueens_move(st, moves, idx, mask, best=best)
    with pytest.raises(TypeError):
        nm.nqueens_move(st, moves, idx, mask, best=best.int(), save=save)
    with pytest.raises(TypeError):
        nm.nqueens_move(st, moves, idx, mask, best=best, save=save.int())
    with pytest.raises(ValueError):
        nm.nqueens_move(st, moves, idx, mask, best=best[:2], save=save)
    with pytest.raises(ValueError, match="share no memory"):
        nm.nqueens_move(st, moves, idx, mask, best=st.rows, save=save)
    for slices in (0, 9):
        with pytest.raises(ValueError, match="_slices"):
            nm.nqueens_move(st, moves, idx, mask, _slices=slices)
    before = tree_map(torch.clone, st)
    nm.nqueens_move(st, moves, idx, torch.zeros(p, dtype=torch.bool))
    assert_bits_equal(st, before)
    launches = nm.nqueens_move.launches
    nm.nqueens_move(st, moves, idx, mask)
    assert nm.nqueens_move.launches == launches  # no kernel on the CPU


def _chunks(n: int, slices: int) -> list:
    """The columns of each block of a lane, as the kernel cuts them: the
    lane's items (pairs of columns when n is even, else single columns) in
    ``slices`` contiguous chunks, block b from items·b/S to items·(b+1)/S."""
    width = 2 if n % 2 == 0 else 1
    items = n // width
    return [range(items * b // slices * width, items * (b + 1) // slices * width) for b in range(slices)]


@pytest.mark.parametrize("args, plan", [
    ((16, 16384, 132, None), (8, 256, 128)),   # the nqueens-16384 cell: 16 lanes, 8 blocks each
    ((256, 1000, 132, None), (1, 256, 256)),   # the headline: enough lanes
    ((5, 16383, 132, None), (8, 256, 40)),     # ragged: n % 8 = 7, single columns
    ((5, 1003, 132, None), (1, 256, 5)),       # under 2 · 1024 columns: one block
    ((16, 4096, 132, None), (4, 256, 64)),     # each of S blocks keeps 1024 columns
    ((100, 16384, 132, None), (2, 256, 200)),  # P·S reaches the SMs
    ((16, 16384, 16, None), (1, 256, 16)),     # a card of 16 SMs: the pass loops
    ((1, 10**6, 132, None), (8, 256, 8)),      # the pass loops
    ((256, 1000, 132, 8), (8, 32, 2048)),      # forced, ragged: 500 pairs over 8 blocks
    ((16, 16384, 132, 1), (1, 256, 16)),       # forced
    ((16, 2048, 132, None), (2, 256, 32)),     # just 2 · 1024 columns: two blocks of 1024
] + [((300, n, 132, None), (1, t, 300)) for n, t in ((1, 32), (128, 32), (129, 64), (512, 128), (1000, 256),
                                                     (16385, 256))],
    ids=str)
def test_launch_plan(args, plan):
    """S, threads and grid for (P, n, SMs, forced S); the
    blocks' chunks cover every column once, and one pass of the threads
    covers the largest chunk unless a block holds more than ``MAX_THREADS ·
    COLUMNS`` columns."""
    got = nm._launch_plan(*args)
    assert tuple(got) == plan
    n = args[1]
    chunks = _chunks(n, got.slices)
    assert [j for c in chunks for j in c] == list(range(n))
    widest = max(len(c) for c in chunks)
    assert widest <= got.threads * nm.COLUMNS or got.threads == nm.MAX_THREADS
    assert got.slices == 1 or args[3] or min(len(c) for c in chunks) >= nm.MIN_CHUNK


def test_kernel_work_counts_the_best_board():
    assert nm.kernel_work(256, 1000) == (13 * 256 * 1000, 9 * 256 + 256 * (8 * 1000 + 68))
    assert nm.kernel_work(16, 16384, masked=3, changed=11) == (
        13 * 3 * 16384 + 11, 9 * 16 + 3 * (8 * 16384 + 68) + 8 * 11)
    assert nm.kernel_work(4, 10, masked=0) == (0, 36)
    # With a best board: save read, 5 boards written, 2 of them (outside the mask) read too.
    assert nm.kernel_work(16, 16384, masked=3, changed=11, saved=5, saved_only=2) == (
        13 * 3 * 16384 + 11, 9 * 16 + 3 * (8 * 16384 + 68) + 8 * 11 + 16 + 8 * 16384 * 7)
    assert nm.kernel_work(4, 10, masked=0, saved=0) == (0, 40)


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
    save = torch.as_tensor(rng.random(p) < 0.5)
    save[:2] = torch.tensor([True, True])
    mask[1] = False  # a lane that saves its board as it is reads it too
    changed = int(((got.cs != st.cs) & off_col & mask[:, None]).sum())  # got moved lane 1 too
    got_work = nm.move_work(st, moves, idx, mask, st.rows.clone(), save)
    assert got_work == nm.kernel_work(p, n, int(mask.sum()), changed, int(save.sum()), int((save & ~mask).sum()))
    assert got_work[1] > nm.move_work(st, moves, idx, mask)[1] + 8 * n * int(save.sum())


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


@pytest.mark.parametrize("with_best", [False, True], ids=["no best", "best"])
def test_the_smoke_timing_rotation_moves_each_copy_there_and_back(monkeypatch, with_best):
    """``chip_smoke.py`` phase 2f times K4 over state copies (and best boards)
    that do not fit the L2: each call moves the next copy, forward on one pass
    and back on the next, so every call does the same work and a cycle
    restores every copy's state, and leaves the saved board in its best."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "L2_BYTES", 1000)  # a few copies of a small state
    rng = np.random.default_rng(8)
    p, n, a = 4, 11, 3
    st = _state(rng, p, n)
    moves = _moves(rng, p, n, a)
    idx = torch.as_tensor(rng.integers(0, a * n, size=p))
    mask = torch.tensor([True, True, False, True])
    best = torch.from_numpy(rng.integers(0, n, size=(p, n))) if with_best else None
    save = torch.tensor([True, False, True, False]) if with_best else None
    copies, call = chip_smoke.k4_rotation(st, moves, idx, mask, best, save)
    extra = 0 if best is None else best.nbytes
    assert len(copies) == -(-chip_smoke.K4_L2_SPAN * 1000 // (st.rows.nbytes + st.cs.nbytes + extra))
    works = []

    def move(state, moves, idx, mask, best, save):
        works.append(nm.move_work(state, moves, idx, mask, best, save))
        nm.nqueens_move(state, moves, idx, mask, best, save)

    for _ in range(len(copies)):
        call(move)
    want = tree_map(torch.clone, st)
    want_best = None if best is None else best.clone()
    nm.nqueens_move_ref(want, moves, idx, mask, want_best, save)
    assert all(chip_smoke.k4_equal(c, want) for c, _ in copies)
    assert all((b is None) == (best is None) and (b is None or torch.equal(b, want_best)) for _, b in copies)
    for _ in range(len(copies)):
        call(move)
    assert all(chip_smoke.k4_equal(c, st) for c, _ in copies)
    if best is not None:
        assert all(torch.equal(b, torch.where(save[:, None], st.rows, best)) for _, b in copies)
    assert len(set(works)) == 1 and works[0][1] > nm.kernel_work(p, n, 3)[1]
