"""PMC's step loop replayed as CUDA graphs (``models/nqueens_parallel.py``'s
``PMCGraphs``), on the CPU.

No CUDA graph runs here.  What runs:

- the static-carry loop with its steps run eagerly (``PMCGraphs(capturer=None)``)
  against the eager loop (``_graphed=False``) and the JAX package's ``pmc_run``,
  all fed the same JAX-key draws (``tests/jax_key_draws.py``): the full block
  and the sampled columns, one call and chunked calls through one holder;
- the static-carry loop with ``tests/test_torch_graphs.py``'s stand-in graph
  (``ReplayGraph``: a capture records the ops and changes nothing, a replay
  runs them again on the same tensors, and a host read or a tensor made from
  host data inside a capture raises), from a CPU ``TorchDraws``, against the
  eager loop;
- the rule that picks the eager loop, the holder's units, the solver's
  ownership of its holder, and a capture that fails.

Equality is exact: boards and step counts are integers, scores small integers
in float32.  The card runs the graphs themselves: ``chip_smoke.py`` phase 5 and
``tests/test_torch_cuda.py``.
"""

from contextlib import nullcontext

import jax
import numpy as np
import pytest
import torch

from constraint_solver_tpu.models import nqueens_parallel as jpmc
from constraint_solver_tpu_torch.core import graphed
from constraint_solver_tpu_torch.models import nqueens_parallel as tpmc
from constraint_solver_tpu_torch.parallel.mesh import use_mesh
from constraint_solver_tpu_torch.utils import roofline
from constraint_solver_tpu_torch.utils.convert import to_reference
from constraint_solver_tpu_torch.utils.draws import LaneSlice, TorchDraws
from constraint_solver_tpu_torch.utils.tree import tree_leaves
from jax_key_draws import JaxKeyDraws, reference_log_weights
from test_torch_graphs import CardDraws, StandIn, replay_capturer
from test_torch_pmc import assert_tree_equal


class ForcedPMC(tpmc.PMCGraphs):
    """Graphed PMC on the CPU, where the rule would pick the eager loop."""

    def applies(self, draws, device):
        return True


def assert_carries_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


# (n, lanes, sample_cols, the steps of each call): one call runs to zero, the
# chunked calls stop mid-solve and continue from the returned carry.
CASES = {
    "full-one-call": (24, 4, None, (500,)),
    "full-chunked": (20, 2, None, (5, 11, 40)),
    "sampled-one-call": (48, 2, 12, (2000,)),
    "sampled-chunked": (48, 2, 12, (7, 30)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_static_carry_loop_matches_eager_and_jax(case):
    """The graphed loop with its steps run eagerly on the static carry: the
    eager loop's trajectory, the same draws consumed, and the JAX package's."""
    n, p, a, chunks = CASES[case]
    keys = jax.random.split(jax.random.key(n + p), p)
    weights = reference_log_weights(n) if a is not None else None

    def port(graphs):
        draws = JaxKeyDraws(keys)
        carry = tpmc.pmc_init(n, draws)
        out = []
        for steps in chunks:
            carry = tpmc.pmc_run(carry, draws, steps, sample_cols=a, log_weights=weights, graphs=graphs,
                                 _graphed=graphs is not None)
            out.append(carry)
        return out, draws

    holder = ForcedPMC(capturer=None)
    (eager, eager_draws), (static, static_draws) = port(None), port(holder)
    assert len(holder._units) == 1  # one unit across the chunks
    for e, s in zip(eager, static, strict=True):
        assert_carries_equal(e, s)
    for k, v in eager_draws.state_dict().items():
        np.testing.assert_array_equal(np.asarray(static_draws.state_dict()[k]), np.asarray(v), err_msg=k)

    def jax_run(k):
        carry = jpmc.pmc_init(n, k)
        out = []
        for steps in chunks:
            carry = jpmc.pmc_run(carry, steps, sample_cols=a)
            out.append(carry)
        return out

    want = jax.vmap(jax_run)(keys)
    for w, s in zip(want, static, strict=True):
        assert_tree_equal(w, to_reference(s))
    if len(chunks) == 1:
        assert (static[-1].score == 0).all()
    else:
        assert (static[0].score > 0).any()  # the first chunk stops mid-solve


@pytest.mark.parametrize("sample_cols", [None, 8], ids=["full", "sampled"])
def test_replayed_step_matches_eager(sample_cols):
    """Capture at a unit's second step, replays after, through one holder over
    two calls: with ``ReplayGraph`` the trajectory and the generator's state
    equal the eager loop's."""
    n, p = 32, 3

    def run(graphs):
        draws = TorchDraws(f"replay-{sample_cols}", p, "cpu")
        carry = tpmc.pmc_run(tpmc.pmc_init(n, draws), draws, 9, sample_cols=sample_cols, graphs=graphs,
                             _graphed=graphs is not None)
        carry = tpmc.pmc_run(carry, draws, 400, sample_cols=sample_cols, graphs=graphs, _graphed=graphs is not None)
        return carry, draws

    holder = ForcedPMC(capturer=replay_capturer)
    (want, want_draws), (got, got_draws) = run(None), run(holder)
    assert_carries_equal(want, got)
    assert torch.equal(got_draws.state_dict()["generator"], want_draws.state_dict()["generator"])
    (unit,) = holder._units.values()
    # Every step after the unit's eager first, up to the done check after the last lane stopped.
    replays, last = unit._step_graph.graph.replays, int(got.steps.max())
    assert last - 1 <= replays < last - 1 + tpmc._DONE_CHECK_EVERY
    assert holder.capture_s > 0
    assert (got.score == 0).all()


@pytest.mark.parametrize(
    "case, want",
    [
        ("graphed", None),
        ("cpu", "CUDA graphs need a CUDA device"),
        ("mesh", "a mesh is active"),
        ("roofline", "a roofline count is active"),
        ("host draws", "no generator on the card"),
        ("lane slice", "no generator on the card"),
        ("jax keys", "no generator on the card"),
    ],
)
def test_rule_picks_the_eager_loop(case, want):
    """``core/graphed``'s rule with no problem: a CUDA device, no mesh, no
    ``roofline`` count and draws whose generator is on the card."""
    device, draws = torch.device("cuda"), CardDraws()
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "host draws":
        draws = TorchDraws("s", 2, "cpu")
    elif case == "lane slice":
        draws = LaneSlice(TorchDraws("s", 2, "cpu"), 0, 1)
    elif case == "jax keys":
        draws = JaxKeyDraws(jax.random.split(jax.random.key(0), 2))
    context = nullcontext()
    if case in ("mesh", "roofline"):
        context = use_mesh(object()) if case == "mesh" else roofline.counting()
    with context:
        reason = graphed.eager_reason(None, draws, device)
        applies = tpmc.PMCGraphs().applies(draws, device)
    assert reason is None if want is None else want in reason
    assert applies is (want is None)


def _no_capturer(device, draws):
    raise AssertionError("the rule picked the graphed loop")


@pytest.mark.parametrize("context", ["cpu", "roofline"])
def test_pmc_runs_eagerly_where_the_rule_says(context):
    """On the CPU, and under a ``roofline`` count, the holder makes no unit."""
    holder = tpmc.PMCGraphs(capturer=_no_capturer)
    with roofline.counting() if context == "roofline" else nullcontext():
        out = tpmc.pmc_solve(16, TorchDraws("rule", 2, "cpu"), max_steps=50, graphs=holder)
    assert not holder._units
    assert_carries_equal(out, tpmc.pmc_solve(16, TorchDraws("rule", 2, "cpu"), max_steps=50, _graphed=False))


def test_holder_keeps_one_unit_per_configuration():
    holder = ForcedPMC(capturer=None)
    draws = TorchDraws("units", 2, "cpu")
    carry = tpmc.pmc_init(24, draws)
    for _ in range(2):
        tpmc.pmc_run(carry, draws, 3, graphs=holder)
    assert len(holder._units) == 1
    tpmc.pmc_run(carry, draws, 3, sample_cols=4, graphs=holder)
    tpmc.pmc_run(carry, draws, 3, p_accept=0.5, graphs=holder)
    other = TorchDraws("units", 3, "cpu")
    tpmc.pmc_run(tpmc.pmc_init(24, other), other, 3, graphs=holder)
    assert len(holder._units) == 4


def test_sampled_unit_keeps_its_table_and_refills_it():
    """The sampled mode's log table is the unit's own tensor, refilled at each
    call: a second call with other weights through the same unit uses them."""
    n, a = 32, 8
    weights = np.log(np.arange(3 * n, dtype=np.float32) + np.float32(1e-4))
    flat = np.zeros(3 * n, np.float32)  # every conflicted column weighs the same

    def run(graphs):
        draws = TorchDraws("table", 2, "cpu")
        kw = dict(sample_cols=a, graphs=graphs, _graphed=graphs is not None)
        first = tpmc.pmc_run(tpmc.pmc_init(n, draws), draws, 10, log_weights=weights, **kw)
        tables = [unit.table.clone() for unit in graphs._units.values()] if graphs is not None else None
        return first, tpmc.pmc_run(first, draws, 60, log_weights=flat, **kw), tables

    holder = ForcedPMC(capturer=None)
    got_first, got_second, (table,) = run(holder)
    (unit,) = holder._units.values()
    assert torch.equal(table, torch.from_numpy(weights)) and torch.equal(unit.table, torch.from_numpy(flat))
    want_first, want_second, _ = run(None)
    assert_carries_equal(got_first, want_first)
    assert_carries_equal(got_second, want_second)
    assert (got_first.score > 0).all()  # the second call has steps to run


def test_failed_capture_raises():
    """A capture that fails raises out of ``pmc_solve``: nothing falls back."""

    def failing(device, draws):
        def capture(fn):
            def boom():
                raise RuntimeError("capture failed")

            return graphed.capture(boom, StandIn())

        return capture

    with pytest.raises(RuntimeError, match="capture failed"):
        tpmc.pmc_solve(16, TorchDraws("fail", 2, "cpu"), max_steps=50, graphs=ForcedPMC(capturer=failing))


def test_solver_owns_its_graphs():
    solver = tpmc.ParallelMinConflictsSolver(16, seed="own", population=2, device="cpu")
    assert isinstance(solver.graphs, tpmc.PMCGraphs)
    assert not solver.graphs._units  # on the CPU the rule picks the eager loop
    other = tpmc.ParallelMinConflictsSolver(16, seed="own", population=2, device="cpu")
    assert other.graphs is not solver.graphs
    eager = tpmc.ParallelMinConflictsSolver(16, seed="own", population=2, device="cpu", _graphed=False)
    assert eager.graphs is None
    assert eager.stats() == solver.stats()
    np.testing.assert_array_equal(eager.get_best_solution()[1].rows, solver.get_best_solution()[1].rows)
