"""The PyTorch port's population solver, the slice as a whole, against the JAX
package's ``PopulationSolver``.

Both solvers start from one seed string, and the port draws through
``tests/jax_key_draws.py``, which follows the JAX key tree, so both consume the
same random numbers.  After every chunk, every leaf of the state must be equal
bitwise (boards, counters, scores, fingerprints, tabu rings, elite archives,
round numbers, ``ls_iters_total``): every score and counter is an integer held in
float32 and every fingerprint a uint32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_make
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem, total_conflicts
from constraint_solver_tpu_torch.parallel import population as tpop
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from jax_key_draws import JaxKeyDraws, reference_log_weights

P = 4


def assert_tree_equal(want, got, path="state"):
    if hasattr(got, "_fields"):
        for f in got._fields:
            assert_tree_equal(getattr(want, f), getattr(got, f), f"{path}.{f}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def _config(seed, exact):
    # Short descents, a small archive and a restart every 4 rounds keep every
    # lane busy for the whole comparison and exercise the restart branch, the
    # archive's replacement of its worst entry and the exchange.
    return dict(
        seed=seed, local_search_max_iterations=6, best_solutions_capacity=3,
        all_solutions_capacity=16, all_solution_iteration_expiry=40, restart_every=4,
        tabu_exact_filter=exact,
    )


def _solvers(n, seed, exact):
    kw = _config(seed, exact)
    jsolver = jpop.PopulationSolver(j_make(n), JConfig(**kw), population=P, exchange_every=2)
    tsolver = tpop.PopulationSolver(
        make_nqueens_problem(n, log_weights=reference_log_weights(n)), SolverConfig(**kw),
        population=P, exchange_every=2,
        draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), P)), device="cpu",
    )
    return jsolver, tsolver


@pytest.mark.parametrize("exact", [None, False], ids=["exact-filter", "pick-then-check"])
@pytest.mark.parametrize("n", [8, 12, 16])
def test_population_trajectory_matches_jax(n, exact):
    jsolver, tsolver = _solvers(n, f"traj-{n}", exact)
    assert tsolver.program.ls_params.tabu_exact_filter == (exact is None)
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    for _ in range(3):  # 6 rounds in chunks of 2, with the exchange after each
        trace_j = jsolver.execute_chunk_traced(2)
        trace_t = tsolver.execute_chunk_traced(2)
        np.testing.assert_array_equal(trace_t, trace_j)
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    assert tsolver.get_iteration_info() == jsolver.get_iteration_info()
    assert tsolver.get_best_score() == jsolver.get_best_score()
    assert tsolver.stats() == jsolver.stats()
    (score_t, state_t), (score_j, state_j) = tsolver.get_best_solution(), jsolver.get_best_solution()
    assert score_t == score_j
    np.testing.assert_array_equal(state_t.rows, state_j.rows)


def test_run_and_execute_round_match_jax():
    """``run`` (chunks of 1 round, stopping when solved) and single rounds,
    which carry the round-gated exchange, follow the JAX solver."""
    jsolver, tsolver = _solvers(12, "run", None)
    jsolver.run(max_rounds=3, chunk=1)
    tsolver.run(max_rounds=3, chunk=1)
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    for _ in range(2):
        jsolver.execute_round()
        tsolver.execute_round()
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))


@pytest.mark.parametrize("cull_frac, cull_rank", [(0.0, "lex"), (0.5, "lex"), (0.5, "hard")])
def test_exchange_elites_matches_jax(cull_frac, cull_rank):
    """The exchange and culling on a state whose lanes have tied scores."""
    jsolver, _ = _solvers(12, "exchange", None)
    st = jsolver._chunk_jit(jsolver.state, 1)
    st = st._replace(current_score=st.current_score.at[:, 1].set(jnp.asarray([1.0, 0.0, 1.0, 0.0])))
    want = jpop.exchange_elites(st, 4, cull_frac, cull_rank=cull_rank)
    got = tpop.exchange_elites(from_reference(st, "cpu"), 4, cull_frac, cull_rank)
    assert_tree_equal(want, to_reference(got))


@pytest.mark.parametrize("mix", ["reference", "mixed"])
def test_portfolio_temps_match_jax(mix):
    for p in (1, 8, 13):
        np.testing.assert_array_equal(
            tpop.portfolio_temps(p, mix).numpy(), np.asarray(jpop.portfolio_temps(p, mix))
        )


def test_state_round_trips_through_reference_layout():
    _, tsolver = _solvers(8, "convert", None)
    tsolver.execute_chunk_traced(2)
    ref = to_reference(tsolver.state)
    back = from_reference(ref, "cpu")
    assert_tree_equal(ref, to_reference(back))


def test_torch_draws_solve_nqueens_8():
    solver = tpop.PopulationSolver(
        make_nqueens_problem(8), SolverConfig(seed="42", local_search_max_iterations=50),
        population=4, exchange_every=2, device="cpu",
    )
    solver.run(chunk=2)
    (hard, soft), state = solver.get_best_solution()
    assert (hard, soft) == (0.0, 0.0)
    assert int(total_conflicts(torch.from_numpy(state.rows))) == 0
    stats = solver.stats()
    assert stats["population"] == 4 and stats["ls_iterations"] > 0 and stats["moves_per_sec"] > 0
    assert not solver.is_finished()
    rounds = solver.get_iteration_info()["current"]
    solver.run()  # already solved: no further rounds
    assert solver.get_iteration_info()["current"] == rounds
    solver.cancel()
    solver.execute_round()
    assert solver.get_iteration_info()["current"] == rounds + 1

