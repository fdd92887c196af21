"""Checkpoint and resume in the PyTorch port (``utils/checkpoint.py``), after the
JAX package's ``tests/test_checkpoint.py``, and ``reseed_from_elites`` against
the JAX package.

A checkpoint holds the state tree, the draw source's state and the host round
counter, so a solver that loads it continues bit for bit: with the production
``TorchDraws`` it equals a run that never stopped, and with JAX-key draws it
equals the JAX package's uninterrupted run."""

import jax
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_make
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.checkpoint import checkpoint_exists, resume_and_run
from constraint_solver_tpu_torch.utils.convert import to_reference
from constraint_solver_tpu_torch.utils.tree import tree_leaves
from jax_key_draws import JaxKeyDraws, reference_log_weights
from test_torch_population import assert_tree_equal


def _cfg(rounds=30, **kw):
    base = dict(
        seed="ckpt", local_search_max_iterations=100, iterated_local_search_max_iterations=rounds,
        all_solutions_capacity=64, all_solution_iteration_expiry=100,
    )
    return SolverConfig(**{**base, **kw})


def assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_solver_checkpoint_roundtrip(tmp_path):
    problem = make_nqueens_problem(10)
    a = Solver(problem, _cfg(), device="cpu")
    a.run(max_rounds=7, chunk=7)
    path = str(tmp_path / "ck.npz")
    a.save(path)
    b = Solver(problem, _cfg(), device="cpu")
    b.load(path)
    assert_states_equal(a.state, b.state)
    assert b.get_iteration_info() == a.get_iteration_info() == {"current": 7, "total": 30}
    a.run(max_rounds=5, chunk=5)
    b.run(max_rounds=5, chunk=5)
    assert_states_equal(a.state, b.state)
    assert a.get_best_score() == b.get_best_score()


@pytest.mark.parametrize("domain", ["nqueens", "qap-incremental"])
def test_population_checkpoint_resumes_bit_for_bit(tmp_path, domain):
    """Save after 4 rounds, load into a fresh solver, run 4 more: equal to 8
    rounds run straight, with the state tree of either domain."""
    if domain == "nqueens":
        problem = make_nqueens_problem(16)
    else:
        problem = make_qap_problem(QAPSpec.random(9, seed=1), incremental=True)

    def solver():
        config = _cfg(local_search_max_iterations=6, restart_every=3)
        return PopulationSolver(problem, config, population=4, exchange_every=2, device="cpu")

    straight = solver()
    straight.run(max_rounds=8, chunk=2)
    a = solver()
    a.run(max_rounds=4, chunk=2)
    path = str(tmp_path / "pk.npz")
    a.save(path)
    b = solver()
    b.load(path)
    for key in ("rounds", "population", "ls_iterations", "moves_evaluated"):
        assert a.stats()[key] == b.stats()[key]
    b.run(max_rounds=4, chunk=2)
    assert_states_equal(straight.state, b.state)
    assert straight.stats()["ls_iterations"] == b.stats()["ls_iterations"]


def test_population_resume_from_jax_keys_equals_jax_run(tmp_path):
    """With the JAX-key draw source, a run saved and resumed halfway equals
    the JAX package's run that never stopped, leaf for leaf."""
    n, p, seed = 16, 4, "ckpt-jax"
    # Short descents: the run must not solve the board before round 6.
    kw = dict(seed=seed, local_search_max_iterations=4, all_solutions_capacity=32, restart_every=3)
    jsolver = jpop.PopulationSolver(j_make(n), JConfig(**kw), population=p, exchange_every=2)

    def solver():
        return PopulationSolver(
            make_nqueens_problem(n, log_weights=reference_log_weights(n)), SolverConfig(**kw), population=p,
            exchange_every=2, draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
        )

    a = solver()
    for _ in range(2):
        a.execute_chunk_traced(2)
    path = str(tmp_path / "jk")
    resume_and_run(a, path, every=100, max_rounds=0)
    assert checkpoint_exists(path)
    b = solver()
    resume_and_run(b, path, every=2, max_rounds=2, chunk=2)
    jsolver.execute_chunk_traced(2)
    jsolver.execute_chunk_traced(2)
    jsolver.execute_chunk_traced(2)
    assert_tree_equal(jsolver.state, to_reference(b.state))
    assert b.get_iteration_info()["current"] == 6


def test_checkpoint_rejects_wrong_problem(tmp_path):
    a = Solver(make_nqueens_problem(8), _cfg(), device="cpu")
    path = str(tmp_path / "x.npz")
    a.save(path)
    b = Solver(make_nqueens_problem(8, sample_cols=2), _cfg(), device="cpu")
    b.problem = b.problem._replace(name="other")
    with pytest.raises(ValueError, match="checkpoint is for"):
        b.load(path)


def test_checkpoint_rejects_population_mode_mismatch(tmp_path):
    problem = make_nqueens_problem(8)
    pop = PopulationSolver(problem, _cfg(), population=4, device="cpu")
    pop.run(max_rounds=2, chunk=2)
    path = str(tmp_path / "pop.npz")
    pop.save(path)
    with pytest.raises(ValueError, match="population-mode"):
        Solver(problem, _cfg(), device="cpu").load(path)
    with pytest.raises(ValueError, match="population"):
        PopulationSolver(problem, _cfg(), population=8, device="cpu").load(path)
    pop.state = pop.state._replace(round=pop.state.round + torch.tensor([0, 0, 1, 0], dtype=torch.int32))
    pop.save(path)
    with pytest.raises(ValueError, match="lockstep"):
        PopulationSolver(problem, _cfg(), population=4, device="cpu").load(path)


def test_checkpoint_path_without_npz_extension(tmp_path):
    problem = make_nqueens_problem(8)
    a = Solver(problem, _cfg(), device="cpu")
    a.run(max_rounds=3, chunk=3, checkpoint_path=str(tmp_path / "bare_path"), checkpoint_every=1)
    path = str(tmp_path / "bare_path")  # no .npz
    assert checkpoint_exists(path) and (tmp_path / "bare_path.npz").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bare_path.npz"]  # no temporary file left
    b = Solver(problem, _cfg(), device="cpu")
    b.load(path)
    assert a.get_best_score() == b.get_best_score()


def test_reseed_from_elites_matches_jax():
    n, p, seed = 8, 4, "reseed"
    kw = dict(seed=seed, local_search_max_iterations=10, best_solutions_capacity=3, all_solutions_capacity=32)
    jsolver = jpop.PopulationSolver(j_make(n), JConfig(**kw), population=p, exchange_every=2)
    tsolver = PopulationSolver(
        make_nqueens_problem(n, log_weights=reference_log_weights(n)), SolverConfig(**kw), population=p,
        exchange_every=2, draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    tsolver.reseed_from_elites()  # empty archives: every lane keeps its solution
    jsolver.reseed_from_elites()
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    for _ in range(2):
        jsolver.execute_chunk_traced(2)
        tsolver.execute_chunk_traced(2)
        jsolver.reseed_from_elites()
        tsolver.reseed_from_elites()
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    np.testing.assert_array_equal(tsolver.execute_chunk_traced(2), jsolver.execute_chunk_traced(2))
