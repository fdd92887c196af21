"""Whole scheduling ``PopulationSolver`` trajectories of the PyTorch port against
the JAX package, leaf for leaf, with the random, dense and noisy dense
proposers.  Both sides draw from the same JAX keys (``tests/jax_key_draws.py``);
equality is exact (small integers in float32, uint32 fingerprints)."""

import jax
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import scheduling as ts
from constraint_solver_tpu_torch.parallel import population as tpop
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from jax_key_draws import JaxKeyDraws
from test_torch_scheduling import _specs, assert_tree_equal


def _traj_config(seed, **kw):
    return dict(
        seed=seed, local_search_max_iterations=8, best_solutions_capacity=3,
        all_solutions_capacity=16, all_solution_iteration_expiry=40, restart_every=3,
        max_allow_no_improvement_for=4, **kw,
    )


@pytest.mark.parametrize(
    "proposer, extra",
    [("random", {}), ("dense", {}), ("dense", {"select_topk": 8, "select_temp": 0.5})],
    ids=["random", "dense", "dense-topk"],
)
def test_population_trajectory_matches_jax(proposer, extra):
    """Whole PopulationSolver runs on 31d x 7e (P=4, exchange every 2 rounds,
    culling a quarter of the lanes, a restart at round 3), leaf for leaf."""
    p = 4
    seed = f"sched-{proposer}-{len(extra)}"
    kw = _traj_config(seed, **extra)
    jspec, tspec = _specs("31d7e-hol")
    pkw = dict(window_size=24) if proposer == "random" else dict(n_rand_swaps=16)
    jsolver = jpop.PopulationSolver(
        js.make_scheduling_problem(jspec, proposer=proposer, **pkw), JConfig(**kw),
        population=p, exchange_every=2, cull_frac=0.25,
    )
    tsolver = tpop.PopulationSolver(
        ts.make_scheduling_problem(tspec, proposer=proposer, **pkw), SolverConfig(**kw),
        population=p, exchange_every=2, cull_frac=0.25,
        draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    assert tsolver.program.ls_params.tabu_exact_filter
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    for _ in range(2):
        np.testing.assert_array_equal(tsolver.execute_chunk_traced(2), jsolver.execute_chunk_traced(2))
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    assert tsolver.stats() == jsolver.stats()
    (score_t, state_t), (score_j, state_j) = tsolver.get_best_solution(), jsolver.get_best_solution()
    assert score_t == score_j
    np.testing.assert_array_equal(state_t, state_j)
    back = from_reference(to_reference(tsolver.state), "cpu")
    assert back.current_state.dtype == torch.int64 and back.elite.states.dtype == torch.int64
    assert_tree_equal(to_reference(tsolver.state), to_reference(back))
