"""QAP's incremental move written in place under the lane mask, and the
descent's best carried by its permutation (``Problem.in_place``;
``models/qap.py``, ``core/local_search.py``).

The JAX package selects whole state trees per lane, and the port's problems
without the field still do.  With it every output must stay bit for bit the
select form's: the masked move against ``apply_move`` followed by the select,
a descent with the field against the same problem with it stripped
(eagerly and through the graphed loop's static carry), and a population solve.
The float tensors are compared by their bits, so a -0 for a +0 fails too.  The
JAX package is held to the select form by ``tests/test_torch_qap.py`` and
``tests/test_torch_graphs_domains.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from constraint_solver_tpu_torch.core.history import TabuRing
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.core.local_search import LsParams, ls_execute
from constraint_solver_tpu_torch.models.qap import QAPMoves, QAPSpec, QAPState, make_qap_problem
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.tree import tree_leaves, tree_map, tree_where
from jax_key_draws import JaxKeyDraws
from test_torch_graphs import Forced

N, P = 24, 4
STRIPPED = dict(in_place=None)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bits_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _instance(n=N, seed=0):
    spec = QAPSpec.random(n, seed=seed)
    flow, dist = (m.astype(np.int64) for m in spec.arrays())
    return spec, flow, dist


def _state(flow, dist, perms):
    """QAPState of ``perms`` with G and H built on the host."""
    g = np.stack([dist[np.ix_(q, q)] for q in perms])
    h = np.einsum("ij,pjk->pik", flow, g)
    return QAPState(torch.tensor(perms), torch.from_numpy(g).float(), torch.from_numpy(h).float())


@pytest.mark.parametrize("mask", ["none", "all", "mixed"])
@pytest.mark.parametrize("form", ["dense", "compact"])
def test_masked_move_equals_move_then_select(mask, form):
    """Swaps that include the first and the last facility: in the lanes of the
    mask the move's G, H and p, equal to D[p][:, p] and F G on the host; in the
    others the old tensors, bit for bit (a -0 in H too)."""
    spec, flow, dist = _instance()
    problem = make_qap_problem(spec, incremental=True)
    rng = np.random.default_rng(1)
    perms = np.stack([rng.permutation(N) for _ in range(P)])
    st = _state(flow, dist, perms)
    a = torch.tensor([0, 0, 5, 7])
    b = torch.tensor([N - 1, 1, N - 1, 19])
    if form == "dense":
        moves, idx = QAPMoves(None, N), a * N + b
    else:
        partner = torch.zeros((P, N), dtype=torch.int64)
        partner[torch.arange(P), a] = b
        moves, idx = QAPMoves(partner, N), a
    on = {"none": [False] * P, "all": [True] * P, "mixed": [True, False, True, False]}[mask]
    on = torch.tensor(on)
    if not on[1]:
        st.h[1, 3] = -0.0  # a lane the mask leaves alone keeps its signed zeros

    old = tree_map(torch.clone, st)
    want = tree_where(on, problem.apply_move(old, moves, idx), old)
    buffers = list(st)
    assert problem.in_place.move(st, moves, idx, on) is None  # written into the state's own buffers
    got = st
    assert all(x is y for x, y in zip(got, buffers))
    assert_bits_equal(got, want)
    for k in range(P):
        if on[k]:
            q, ak, bk = perms[k].copy(), int(a[k]), int(b[k])
            q[[ak, bk]] = q[[bk, ak]]
            np.testing.assert_array_equal(got.p[k].numpy(), q)
            np.testing.assert_array_equal(got.g[k].numpy(), dist[np.ix_(q, q)])
            np.testing.assert_array_equal(got.h[k].numpy(), flow @ dist[np.ix_(q, q)])
        else:
            assert_bits_equal(QAPState(*(x[k] for x in got)), QAPState(*(x[k] for x in old)))


def test_best_key_rebuilds_the_state():
    spec, flow, dist = _instance()
    problem = make_qap_problem(spec, incremental=True)
    rng = np.random.default_rng(2)
    st = _state(flow, dist, np.stack([rng.permutation(N) for _ in range(P)]))
    key = problem.in_place.key(st)
    assert key is st.p
    assert_bits_equal(problem.in_place.rebuild(key), st)


def test_problems_without_the_field_keep_it_unset():
    spec, _, _ = _instance(8)
    for kw in ({}, {"compact": True}):
        assert make_qap_problem(spec, **kw).in_place is None


def _descend(problem, exact, graphs, start, enabled, keys):
    draws = JaxKeyDraws(keys)
    draws.round_keys()
    params = LsParams(max_iterations=30, allow_no_improvement_for=6, tabu_retries=4, tabu_exact_filter=exact)
    tabu = TabuRing.create(P, 16, 40, "cpu").push(problem.fingerprint(start))
    return ls_execute(problem, params, start, tabu, draws, enabled, graphs=graphs)


@pytest.mark.parametrize("exact", [True, False], ids=["exact-filter", "pick-then-check"])
@pytest.mark.parametrize("loop", ["eager", "graphed"])
def test_descent_with_the_field_equals_the_select_form(loop, exact):
    """``ls_execute`` from the same draws, with the field and with it
    stripped: best state, best score, tabu ring, iterations and exhaustion
    bit for bit; one lane disabled, one lane stopped early by ``is_best`` (its
    best is the state it stopped at); ``start_state`` left as it was."""
    spec, flow, dist = _instance()
    base = make_qap_problem(spec, incremental=True)
    rng = np.random.default_rng(3)
    start = _state(flow, dist, np.stack([rng.permutation(N) for _ in range(P)]))
    start_cost = base.score(start)[:, 0]
    goal = start_cost[2] - 40.0  # lane 2 stops once it gains 40

    def is_best(s):
        return (torch.arange(s.shape[0]) == 2) & (s[..., 0] <= goal)

    base = base._replace(is_best=is_best)
    enabled = torch.tensor([True, True, True, False])
    keys = jax.random.split(jax.random.key(4), P)
    before = tree_map(torch.clone, start)
    runs, carries = [], []
    for problem in (base, base._replace(**STRIPPED)):
        graphs = Forced(capturer=None) if loop == "graphed" else None
        runs.append(_descend(problem, exact, graphs, start, enabled, keys))
        assert_bits_equal(start, before)
        if graphs is not None:  # the static carry's state too: a stopped or disabled lane keeps its own
            (unit,) = graphs._units.values()
            carries.append(unit.carry.state)
    (best, score, tabu, it, exhausted), want = runs
    assert_bits_equal((best, score, tabu, it, exhausted), want)
    if carries:
        assert_bits_equal(*carries)
    assert int(it[3]) == 0 and int(it[0]) > 2
    assert bool(is_best(score)[2])  # the stopping lane reached its goal
    assert bool((score[:3, 0] < start_cost[:3]).all())
    for k in range(P):
        q = best.p[k].numpy()
        np.testing.assert_array_equal(best.g[k].numpy(), dist[np.ix_(q, q)])
        np.testing.assert_array_equal(best.h[k].numpy(), flow @ dist[np.ix_(q, q)])


@pytest.mark.parametrize("loop", ["eager", "graphed"])
def test_population_solve_with_the_field_equals_the_select_form(loop):
    """Three rounds of a ``PopulationSolver`` with the field and with it
    stripped: traces, state trees (elite archive, tabu rings, counters) and
    ``stats()`` equal."""
    spec, _, _ = _instance(16, seed=5)
    config = SolverConfig(seed="qap-inplace", local_search_max_iterations=12, best_solutions_capacity=4,
                          all_solutions_capacity=32, restart_every=3, max_allow_no_improvement_for=4)
    problem = make_qap_problem(spec, incremental=True)
    out = []
    for prob in (problem, problem._replace(**STRIPPED)):
        s = PopulationSolver(prob, config, population=P, exchange_every=2, device="cpu")
        if loop == "graphed":
            s.program = dataclasses.replace(s.program, graphs=Forced(capturer=None))
        out.append((s.execute_chunk_traced(3), s.state, s.stats()))
    (trace, state, stats), (trace0, state0, stats0) = out
    np.testing.assert_array_equal(trace, trace0)
    assert_bits_equal(state, state0)
    assert stats == stats0 and stats["rounds"] == 3
    for lane in range(P):  # the carried current state is its permutation's G and H
        cur = QAPState(*(x[lane : lane + 1] for x in state.current_state))
        assert_bits_equal(problem.in_place.rebuild(cur.p), cur)

