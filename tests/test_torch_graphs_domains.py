"""The descent replayed as CUDA graphs (``core/graphed.py``) for scheduling,
QAP, Ackley and the diagram layout, on the CPU.

No CUDA graph runs here.  Each opted-in problem and mode runs the graphed loop
with ``tests/test_torch_graphs.py``'s stand-in graph (``ReplayGraph``: a capture
records the ops and changes nothing, a replay runs them again on the same
tensors, and a host read or a tensor made from host data inside a capture
raises) against the eager loop, from one CPU ``TorchDraws`` seed, in both tabu
modes: the traces, the state trees, ``stats()``, the generator's state and the
iterations a wrapper of ``neighborhood`` sees must be equal.  A capture on a
side stream is ordered after the current stream's queued work and before its
next work (stand-in streams).  The phased
solver's two problems make two units of its one ``DescentGraphs``.  Every
opted-in neighborhood returns at once when a replayed iteration calls it, and
each factory's ``capturable`` follows the rule (QAP with ``nbr_axis`` stays
eager).  The card runs the graphs themselves: ``chip_smoke.py`` phase 4c.
"""

import contextlib
import dataclasses
import datetime

import numpy as np
import pytest
import torch

from constraint_solver_tpu_torch.core import graphed
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models.ackley import make_ackley_problem
from constraint_solver_tpu_torch.models.diagram_layout import DiagramLayoutSpec, make_diagram_layout_problem
from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem
from constraint_solver_tpu_torch.parallel.phased import Phase, PhasedPopulationSolver
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from test_torch_graphs import Forced, assert_states_equal, counted, replay_capturer, run_pair

P = 4
MODES = pytest.mark.parametrize("exact", [True, False], ids=["exact-filter", "pick-then-check"])
D0 = datetime.date(2022, 5, 9)


def roster_spec():
    """The reference CLI instance, 31 days x 7 employees, with a few holidays."""
    hols = {e: [D0 + datetime.timedelta(days=(5 * e + 3 * k) % 31) for k in range(2)] for e in range(7)}
    return ScheduleSpec.from_dates(D0, D0 + datetime.timedelta(days=30), 7, hols)


# Every opted-in problem and mode, at a small size: (factory, extra config).
DOMAINS = {
    "scheduling-random": (lambda: make_scheduling_problem(roster_spec(), window_size=24, proposer="random"), {}),
    "scheduling-rescore": (lambda: make_scheduling_problem(roster_spec(), window_size=16, proposer="rescore"), {}),
    "scheduling-dense": (lambda: make_scheduling_problem(roster_spec(), proposer="dense", n_rand_swaps=16), {}),
    "scheduling-dense-noisy": (
        lambda: make_scheduling_problem(roster_spec(), proposer="dense", n_rand_swaps=16),
        {"select_topk": 8, "select_temp": 0.5},
    ),
    "scheduling-systematic": (lambda: make_scheduling_problem(roster_spec(), proposer="systematic"), {}),
    "qap-dense": (lambda: make_qap_problem(QAPSpec.random(16, seed=0)), {}),
    "qap-compact": (lambda: make_qap_problem(QAPSpec.random(16, seed=0), compact=True), {}),
    "qap-incremental": (lambda: make_qap_problem(QAPSpec.random(16, seed=0), incremental=True), {}),
    "ackley": (lambda: make_ackley_problem(4), {}),
    "diagram": (lambda: make_diagram_layout_problem(DiagramLayoutSpec.random(6, 8, 8, seed=0, max_size=3)), {}),
}


def _config(seed, exact, **kw):
    return SolverConfig(
        seed=seed, local_search_max_iterations=12, best_solutions_capacity=4, all_solutions_capacity=64,
        restart_every=3, tabu_exact_filter=exact, **kw,
    )


@MODES
@pytest.mark.parametrize("domain", list(DOMAINS))
def test_replayed_graphs_match_eager(domain, exact):
    """Capture at a unit's second iteration, R at its first retry, replays
    after: with ``ReplayGraph`` every opted-in problem follows the eager
    trajectory bit for bit, consumes the same draws and shows a wrapper of
    ``neighborhood`` the same iterations."""
    factory, extra = DOMAINS[domain]
    config = _config(f"graphs-{domain}", exact, **extra)
    calls = []

    def make():
        problem, count = counted(factory())
        calls.append(count)
        return PopulationSolver(problem, config, population=P, exchange_every=2, device="cpu")

    graphs = Forced(capturer=replay_capturer)
    eager, graph = run_pair(make, graphs, chunks=1)
    assert torch.equal(graph.draws.state_dict()["generator"], eager.draws.state_dict()["generator"])
    assert calls[0]["calls"] == calls[1]["calls"] > 0
    (unit,) = graphs._units.values()
    assert unit._a.graph.replays > 1 and unit._b.graph.replays == unit._a.graph.replays
    assert not unit._a.launches and not unit._b.launches  # no N-Queens kernel on these paths
    if exact:
        assert unit._r is None
    elif domain.startswith(("qap", "diagram")):  # a swap or relocation back is tabu: R is captured and replayed
        assert unit._r is not None and unit._r.graph.replays > 0


def test_phased_solver_makes_one_unit_per_phase():
    """The phased solver's programs descend through its base solver's graphs:
    dense, then the random window, two units of one ``DescentGraphs``, and the
    same trajectory as the eager run (the CPU's)."""
    spec = roster_spec()
    config = _config("phased", None)

    def make():
        phases = [
            Phase(make_scheduling_problem(spec, proposer="dense", n_rand_swaps=16), config, until_round=2),
            Phase(make_scheduling_problem(spec, window_size=24, proposer="random"),
                  dataclasses.replace(config, iterated_local_search_max_iterations=4)),
        ]
        return PhasedPopulationSolver(phases, population=P, exchange_every=2, device="cpu")

    eager, graph = make(), make()
    assert all(p.graphs is graph._base.program.graphs is not None for p in graph._programs)
    graphs = Forced(capturer=replay_capturer)
    graph._programs = [dataclasses.replace(p, graphs=graphs) for p in graph._programs]
    eager.run(chunk=2)
    graph.run(chunk=2)
    assert_states_equal(eager, graph)
    wall_free = lambda s: {k: v for k, v in s.stats().items() if k != "moves_per_sec"}  # noqa: E731
    assert wall_free(graph) == wall_free(eager)
    assert torch.equal(graph.draws.state_dict()["generator"], eager.draws.state_dict()["generator"])
    assert [unit.problem for unit in graphs._units.values()] == [p.problem for p in graph.phases]
    assert not eager._base.program.graphs._units  # on the CPU the rule picks the eager loop


@pytest.mark.parametrize("domain", list(DOMAINS))
def test_replayed_iteration_call_returns_at_once(domain):
    problem = DOMAINS[domain][0]()
    assert problem.neighborhood(None, None, None, None) is None


QAP16 = QAPSpec.random(16, seed=0)


@pytest.mark.parametrize(
    "case, want",
    [
        ("nqueens", True),
        ("nqueens nbr_axis", False),
        ("scheduling dense", True),
        ("scheduling random", True),
        ("scheduling rescore", True),
        ("scheduling systematic", True),
        ("scheduling window 100", True),
        ("qap dense", True),
        ("qap compact", True),
        ("qap incremental", True),
        ("qap nbr_axis", False),
        ("ackley", True),
        ("diagram", True),
    ],
)
def test_factories_declare_capturable(case, want):
    """Every factory opts in, except a neighborhood that gathers over the
    mesh (``nbr_axis``); a capturable problem on the card with draws there
    replays its descents as graphs."""
    problems = {
        "nqueens": lambda: make_nqueens_problem(8),
        "nqueens nbr_axis": lambda: make_nqueens_problem(8, nbr_axis="nbr", nbr_shards=2),
        "scheduling dense": lambda: make_scheduling_problem(roster_spec(), proposer="dense"),
        "scheduling random": lambda: make_scheduling_problem(roster_spec(), proposer="random"),
        "scheduling rescore": lambda: make_scheduling_problem(roster_spec(), proposer="rescore"),
        "scheduling systematic": lambda: make_scheduling_problem(roster_spec(), proposer="systematic"),
        "scheduling window 100": lambda: make_scheduling_problem(roster_spec(), window_size=100, proposer="random"),
        "qap dense": lambda: make_qap_problem(QAP16),
        "qap compact": lambda: make_qap_problem(QAP16, compact=True),
        "qap incremental": lambda: make_qap_problem(QAP16, incremental=True),
        "qap nbr_axis": lambda: make_qap_problem(QAP16, nbr_axis="nbr", nbr_shards=2),
        "ackley": lambda: make_ackley_problem(10),
        "diagram": lambda: make_diagram_layout_problem(DiagramLayoutSpec.random(6, 8, 8, seed=0)),
    }
    problem = problems[case]()
    assert problem.capturable is want

    class CardDraws:
        def graph_generator(self):
            return "generator"

    reason = graphed.eager_reason(problem, CardDraws(), torch.device("cuda"))
    assert (reason is None) is want
    if not want:
        assert "is not capturable" in reason


def test_ackley_divides_by_a_tensor_filled_on_the_device():
    """The Ackley score, which every neighborhood call computes, makes no
    tensor from host data (a copy a capture cannot hold), and equals the
    float64 function."""
    from constraint_solver_tpu_torch.models.ackley import ackley, ackley_np
    from test_torch_graphs import Ops

    x = torch.tensor([[0.5, -1.25, 3.0, 7.5], [0.0, 0.0, 0.0, 0.0]])
    with Ops() as mode:
        got = ackley(x)
    assert torch.ops.aten.lift_fresh.default not in mode.ops
    np.testing.assert_allclose(got.numpy(), ackley_np(x.numpy()), rtol=1e-5, atol=1e-5)


class _Stream:
    """A stand-in CUDA stream that records its waits."""

    device = torch.device("cuda", 0)

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def wait_stream(self, other):
        self.calls.append(f"{self.name} waits for {other.name}")


class _Graph:
    def __init__(self, calls):
        self.calls = calls

    def register_generator_state(self, generator):
        self.calls.append("register")

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")


@pytest.mark.parametrize("fails", [False, True], ids=["captured", "failed"])
def test_capture_on_a_side_stream_is_ordered_with_the_current_stream(monkeypatch, fails):
    """``capture_begin`` refills the registered generator's seed and offset on
    the capturing stream: that stream first waits for the replays queued on the
    current one (an exact-filter iteration captures B right after A's replay,
    with no host read between), and the current stream waits for it after."""
    calls = []
    side, current = _Stream("side", calls), _Stream("current", calls)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: current)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())

    def segment():
        calls.append("segment")
        if fails:
            raise ValueError("boom")
        return "out"

    with pytest.raises(ValueError, match="boom") if fails else contextlib.nullcontext():
        graphed.capture(segment, _Graph(calls), stream=side, generator="gen")
    assert calls == ["register", "side waits for current", "begin", "segment", "end", "current waits for side"]
