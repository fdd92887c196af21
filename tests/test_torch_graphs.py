"""The descent replayed as CUDA graphs (``core/graphed.py``), on the CPU.

No CUDA graph runs here.  What runs:

- the graphed loop with its segments run eagerly (``DescentGraphs(capturer=None)``:
  segment A, the host read, R, B, on the static carry) against the eager loop,
  on a nqueens-64 P=8 trajectory fed by ``tests/jax_key_draws.py``, in both tabu
  modes, and both against the JAX package;
- the graphed loop with a stand-in graph that has a CUDA graph's semantics on
  the CPU (``ReplayGraph``: a capture records the ops and changes nothing, a
  replay runs them again on the same tensors), from a CPU ``TorchDraws``, against
  the eager loop;
- the capture's accounting of the kernel's launch counters, with a stand-in
  graph that records its calls;
- the rule that picks the eager loop, the solvers' ownership of their graphs,
  and ``make_score`` without a tensor made from host data.

The card runs the graphs themselves: ``chip_smoke.py``'s graphed-against-eager
phase.
"""

import dataclasses
import datetime
from collections import Counter
from contextlib import nullcontext

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_make
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core import graphed
from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem
from constraint_solver_tpu_torch.ops import launch_count, lex
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops import qap_row_min as qrm
from constraint_solver_tpu_torch.parallel.mesh import use_mesh
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils import roofline
from constraint_solver_tpu_torch.utils.convert import to_reference
from constraint_solver_tpu_torch.utils.draws import LaneSlice, TorchDraws
from constraint_solver_tpu_torch.utils.tree import tree_leaves
from jax_key_draws import JaxKeyDraws, reference_log_weights

N, P = 64, 8
MODES = pytest.mark.parametrize("exact", [None, False], ids=["exact-filter", "pick-then-check"])


def _config(seed, exact, **kw):
    # chip_smoke.py phase 3's configuration: descents of up to 40 iterations,
    # a restart every 4 rounds, a 64-entry ring.
    return dict(
        seed=seed, local_search_max_iterations=40, best_solutions_capacity=4, all_solutions_capacity=64,
        restart_every=4, tabu_exact_filter=exact, **kw,
    )


class Forced(graphed.DescentGraphs):
    """Graphed descents on the CPU, where the rule would pick the eager loop."""

    def applies(self, problem, draws, device):
        return True


def counted(problem):
    calls = Counter()
    inner = problem.neighborhood

    def neighborhood(*args):
        calls["calls"] += 1
        return inner(*args)

    return problem._replace(neighborhood=neighborhood), calls


def assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def run_pair(make_solver, graphs, chunks=3):
    """(eager solver, graphed solver) after ``chunks`` chunks of 2 rounds, their
    traces equal after every chunk."""
    eager, graph = make_solver(), make_solver()
    graph.program = dataclasses.replace(graph.program, graphs=graphs)
    for _ in range(chunks):
        np.testing.assert_array_equal(graph.execute_chunk_traced(2), eager.execute_chunk_traced(2))
        assert_states_equal(eager, graph)
    assert graph.stats() == eager.stats()
    return eager, graph


@MODES
def test_static_carry_loop_matches_eager_and_jax(exact):
    """A, the host read, R and B run eagerly on the static carry: the same
    trajectory as the eager loop, the same draws consumed, the same iterations
    seen by a wrapper of ``neighborhood``; and both the JAX package's."""
    seed = f"graphs-{N}"
    kw = _config(seed, exact)
    problems = []

    def make():
        problem, calls = counted(make_nqueens_problem(N, log_weights=reference_log_weights(N)))
        problems.append(calls)
        draws = JaxKeyDraws(jax.random.split(seed_string_to_key(seed), P))
        return PopulationSolver(
            problem, SolverConfig(**kw), population=P, exchange_every=2, draws=draws, device="cpu"
        )

    graphs = Forced(capturer=None)
    eager, graph = run_pair(make, graphs)
    assert graph.draws.state_dict().keys() == eager.draws.state_dict().keys()
    for k, v in eager.draws.state_dict().items():
        np.testing.assert_array_equal(np.asarray(graph.draws.state_dict()[k]), np.asarray(v), err_msg=k)
    assert problems[0]["calls"] == problems[1]["calls"] > 0
    assert len(graphs._units) == 1

    jsolver = jpop.PopulationSolver(j_make(N), JConfig(**kw), population=P, exchange_every=2)
    for _ in range(3):
        jsolver.execute_chunk_traced(2)
    want, got = jsolver.state, to_reference(graph.state)
    for f in got._fields:
        for x, y in zip(jax.tree.leaves(getattr(want, f)), jax.tree.leaves(getattr(got, f)), strict=True):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f)


class ReplayGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` with a CUDA graph's semantics on
    the CPU.  A capture records the aten ops issued between ``capture_begin`` and
    ``capture_end`` and then undoes what they did: it puts back every tensor made
    before the capture that an op wrote, and every registered generator's state,
    as a capture on the card runs nothing.  A replay runs the recorded ops again,
    on the same tensor objects (a CUDA graph's fixed addresses), writing each
    op's result into the tensor the capture left.  A host read or a tensor made
    from host data inside a capture raises, as it would on the card."""

    def __init__(self):
        self.ops, self.generators, self.replays = [], [], 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self._states = [g.get_state() for g in self.generators]
        self._recorder = _Recorder(self)
        self._recorder.__enter__()

    def capture_end(self):
        self._recorder.__exit__(None, None, None)
        for t, old in reversed(self._recorder.saved):
            t.copy_(old)
        for g, state in zip(self.generators, self._states):
            g.set_state(state)

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            if func._schema.is_mutable or func.is_view:
                continue
            for dst, src in zip(tree_flatten(out)[0], tree_flatten(res)[0], strict=True):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)


class _Recorder(TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph, self.saved, self.born = graph, [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default):
            raise RuntimeError(f"{func} inside a capture")
        inputs = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        if func._schema.is_mutable:
            self.saved += [(t, t.clone()) for t in inputs if t.untyped_storage().data_ptr() not in self.born]
        out = func(*args, **kwargs)
        # Storage the op allocated (not a view of, or a write into, an input's).
        seen = {t.untyped_storage().data_ptr() for t in inputs}
        self.born.update(ptr for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)
                         if (ptr := t.untyped_storage().data_ptr()) not in seen)
        self.graph.ops.append((func, args, kwargs, out))
        return out


def replay_capturer(device, draws):
    return lambda fn: graphed.capture(fn, ReplayGraph(), generator=draws._gen)


@MODES
@pytest.mark.parametrize("n", [8, N])
def test_replayed_graphs_match_eager(exact, n):
    """Capture at a unit's second iteration, R at its first retry, replays
    after: with ``ReplayGraph`` the trajectory, the generator's state and the
    iterations a wrapper of ``neighborhood`` sees equal the eager loop's."""
    seed = f"replay-{n}"
    kw = _config(seed, exact)
    problems = []

    def make():
        problem, calls = counted(make_nqueens_problem(n))
        problems.append(calls)
        return PopulationSolver(problem, SolverConfig(**kw), population=P, exchange_every=2, device="cpu")

    graphs = Forced(capturer=replay_capturer)
    eager, graph = run_pair(make, graphs)
    assert torch.equal(graph.draws.state_dict()["generator"], eager.draws.state_dict()["generator"])
    assert problems[0]["calls"] == problems[1]["calls"] > 0
    (unit,) = graphs._units.values()
    assert unit._a.graph.replays > 1 and unit._b.graph.replays == unit._a.graph.replays
    if exact is None:
        assert unit._r is None
    if n == 8 and exact is False:  # a small board meets tabu candidates: R is captured and replayed
        assert unit._r is not None and unit._r.graph.replays > 0
    assert graphs.capture_s > 0


class StandIn:
    """A stand-in graph that records its calls and runs nothing."""

    def __init__(self):
        self.calls = []

    def register_generator_state(self, generator):
        self.calls.append(("register", generator))

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append(("begin", pool, capture_error_mode))

    def capture_end(self):
        self.calls.append(("end",))

    def replay(self):
        self.calls.append(("replay",))


def test_capture_counts_no_launch_and_each_replay_counts_what_it_captured():
    """Every hand-written kernel's launches (B1's and K1's here) go to the
    capture's tally, and each replay adds them to that kernel's counters."""
    fn, k1 = nk.nqueens_neighborhood_scores, qrm.qap_swap_row_min
    saved = {w: (w.launches, Counter(w.shapes)) for w in (fn, k1)}

    def segment():
        launch_count.count(fn, (2, 3, 8))  # what the wrappers' launches do
        launch_count.count(fn, (2, 3, 8))
        launch_count.count(fn, (1, 8, 8))
        launch_count.count(k1, (4, 64))
        return "out"

    g = StandIn()
    seg = graphed.capture(segment, g, pool="pool", generator="gen")
    assert g.calls == [("register", "gen"), ("begin", "pool", "thread_local"), ("end",)]
    assert seg.out == "out"
    assert seg.launches == Counter({(fn, (2, 3, 8)): 2, (fn, (1, 8, 8)): 1, (k1, (4, 64)): 1})
    assert all((w.launches, w.shapes) == saved[w] for w in (fn, k1))
    for _ in range(3):
        seg.replay()
    assert g.calls[3:] == [("replay",)] * 3
    assert fn.launches == saved[fn][0] + 9 and k1.launches == saved[k1][0] + 3
    want = Counter(saved[fn][1])
    want.update({(2, 3, 8): 6, (1, 8, 8): 3})
    assert fn.shapes == want and k1.shapes[(4, 64)] == saved[k1][1][(4, 64)] + 3
    launch_count.count(fn, (2, 3, 8))  # outside a capture: on the counters
    assert fn.launches == saved[fn][0] + 10
    for w, (launches, shapes) in saved.items():
        w.launches, w.shapes = launches, shapes


def test_failed_capture_raises_its_error_and_counts_nothing():
    fn = nk.nqueens_neighborhood_scores
    launches0 = fn.launches

    def segment():
        launch_count.count(fn, (2, 3, 8))
        raise ValueError("boom")

    g = StandIn()
    with pytest.raises(ValueError, match="boom"):
        graphed.capture(segment, g)
    assert g.calls == [("begin", None, "thread_local"), ("end",)]
    assert fn.launches == launches0
    launch_count.count(fn, (2, 3, 8))
    assert fn.launches == launches0 + 1
    fn.launches = launches0


class CardDraws:
    """A draw source whose generator is on the card, without one."""

    def graph_generator(self):
        return "generator"


def _host_draws():
    return TorchDraws("s", 2, "cpu")


@pytest.mark.parametrize(
    "case, want",
    [
        ("graphed", None),
        ("cpu", "CUDA graphs need a CUDA device"),
        ("not capturable", "is not capturable"),
        ("sharded neighborhood", "is not capturable"),
        ("scheduling", None),
        ("mesh", "a mesh is active"),
        ("roofline", "a roofline count is active"),
        ("host draws", "no generator on the card"),
        ("lane slice", "no generator on the card"),
        ("jax keys", "no generator on the card"),
    ],
)
def test_rule_picks_the_eager_loop(case, want):
    cuda, problem, draws = torch.device("cuda"), make_nqueens_problem(8), CardDraws()
    if case == "cpu":
        cuda = torch.device("cpu")
    elif case == "not capturable":
        problem = problem._replace(capturable=False)
    elif case == "sharded neighborhood":
        problem = make_nqueens_problem(8, nbr_axis="nbr", nbr_shards=2)
    elif case == "scheduling":
        spec = ScheduleSpec.from_dates(datetime.date(2022, 5, 9), datetime.date(2022, 6, 8), 7, {})
        problem = make_scheduling_problem(spec)
    elif case == "host draws":
        draws = _host_draws()
    elif case == "lane slice":
        draws = LaneSlice(_host_draws(), 0, 1)
    elif case == "jax keys":
        draws = JaxKeyDraws(jax.random.split(jax.random.key(0), 2))
    context = nullcontext()
    if case in ("mesh", "roofline"):
        context = use_mesh(object()) if case == "mesh" else roofline.counting()
    with context:
        got = graphed.eager_reason(problem, draws, cuda)
        applies = graphed.DescentGraphs().applies(problem, draws, cuda)
    assert got is None if want is None else want in got
    assert applies is (want is None)


def test_solvers_own_their_graphs():
    config = SolverConfig(**_config("own", None))
    def pop(**kw):
        return PopulationSolver(make_nqueens_problem(8), config, population=2, device="cpu", **kw)

    solver = pop()
    assert isinstance(solver.program.graphs, graphed.DescentGraphs)
    assert solver.program.graphs is not pop().program.graphs
    assert pop(_graphed=False).program.graphs is None
    assert isinstance(Solver(make_nqueens_problem(8), config, device="cpu").graphs, graphed.DescentGraphs)
    assert Solver(make_nqueens_problem(8), config, device="cpu", _graphed=False).graphs is None
    solver.run(max_rounds=2, chunk=2)  # on the CPU the rule picks the eager loop: no unit is made
    assert not solver.program.graphs._units
    assert make_nqueens_problem(8).neighborhood(None, None, None, None) is None


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("soft", [None, 2.0, "tensor"])
def test_make_score_makes_no_tensor_from_host_data(soft):
    hard = torch.tensor([[3.0, 0.0, 8.0], [1.0, 2.0, 5.0]])
    args = () if soft is None else (torch.full((2, 3), 4.0),) if soft == "tensor" else (soft,)
    with Ops() as mode:
        got = lex.make_score(hard, *args)
    assert torch.ops.aten.lift_fresh.default not in mode.ops
    soft_want = torch.full_like(hard, {None: 0.0, "tensor": 4.0}.get(soft, soft))
    want = torch.stack([hard, soft_want], dim=-1)
    assert got.dtype == want.dtype == torch.float32 and got.device == hard.device and torch.equal(got, want)


def test_noisy_select_makes_no_tensor_from_host_data():
    scores = torch.tensor([[[1.0, 0.0], [0.0, 3.0], [0.0, 1.0]]])
    with Ops() as mode:
        lex.noisy_lex_select(scores, torch.ones(1, 3, dtype=torch.bool), 2, 0.5, torch.zeros(1, 3))
    assert torch.ops.aten.lift_fresh.default not in mode.ops
