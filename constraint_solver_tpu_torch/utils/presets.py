"""Configuration presets (port of ``constraint_solver_tpu/utils/presets.py``).

The same five presets, field for field: the reference's hard-coded constants of
each entry point, and the two measured scheduling quality configurations.  The
problem-side settings go to the problem factories, as in the JAX package.
"""

from __future__ import annotations

from constraint_solver_tpu_torch.core.ils import SolverConfig


def nqueens_cli(seed: str = "42") -> SolverConfig:
    """The reference N-Queens CLI's constants (the window of 5n is the
    problem's neighborhood, see ``make_nqueens_problem``)."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=10_000,
        best_solutions_capacity=32,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=10_000,
        max_allow_no_improvement_for=5,
    )


def scheduling_cli(seed: str = "42") -> SolverConfig:
    """The reference scheduling CLI's constants; ``window_size=100`` goes to
    ``make_scheduling_problem``."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=1_000,
        best_solutions_capacity=64,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=250,
        max_allow_no_improvement_for=20,
    )


def scheduling_quality(seed: str = "42") -> SolverConfig:
    """The quality-at-wall configuration: the reference CLI's engine constants
    with a smaller archive and ring, for a ``PopulationSolver`` over
    ``make_scheduling_problem(spec, proposer="random", window_size=100)`` with
    ``exchange_every=2``, ``cull_frac=0.25`` and 64-128 lanes."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=1_000,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=20,
    )


def scheduling_dense_quality(seed: str = "42") -> SolverConfig:
    """The noisy dense configuration: ``make_scheduling_problem(spec,
    proposer="dense", n_rand_swaps=256)`` with the applied move sampled from
    the 64 best candidates at temperature 0.5 instead of the argmin."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=200,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=1_000,
        iterated_local_search_max_iterations=100_000,
        max_allow_no_improvement_for=20,
        select_topk=64,
        select_temp=0.5,
    )


def ackley_test(seed: str = "0") -> SolverConfig:
    """The reference ILS convergence tests' constants (the move sizes go to
    the Ackley problem factory)."""
    return SolverConfig(
        seed=seed,
        local_search_max_iterations=100_000,
        best_solutions_capacity=16,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=10_000,
        max_allow_no_improvement_for=5,
    )
