"""The port's solver entry points run on the card unless the caller asks for another device.

``Solver``, ``PopulationSolver``, ``PhasedPopulationSolver`` and
``ParallelMinConflictsSolver`` take ``device="cuda"`` by default, with no check
for a card and no fallback: where there is no CUDA device, a solver built
without ``device`` raises and runs nothing on the CPU.  Every other CPU test
passes ``device="cpu"``."""

import inspect

import pytest
import torch

from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
from constraint_solver_tpu_torch.models.nqueens_parallel import ParallelMinConflictsSolver
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.parallel.phased import Phase, PhasedPopulationSolver
from constraint_solver_tpu_torch.parallel.population import PopulationSolver


def _config():
    return SolverConfig(seed="default-device", local_search_max_iterations=5, best_solutions_capacity=2,
                        all_solutions_capacity=8)


BUILDERS = {
    Solver: lambda: Solver(make_nqueens_problem(8), _config()),
    PopulationSolver: lambda: PopulationSolver(make_nqueens_problem(8), _config(), population=2),
    PhasedPopulationSolver: lambda: PhasedPopulationSolver([Phase(make_nqueens_problem(8), _config())], population=2),
    ParallelMinConflictsSolver: lambda: ParallelMinConflictsSolver(8, max_steps=5, population=2),
}


def _tensor_of(solver) -> torch.Tensor:
    if isinstance(solver, ParallelMinConflictsSolver):
        return solver._out.score
    return solver.state.current_score


@pytest.mark.parametrize("cls", list(BUILDERS), ids=lambda c: c.__name__)
def test_solver_defaults_to_the_card(cls, monkeypatch):
    assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    ran = []
    monkeypatch.setattr(nk, "nqueens_neighborhood_scores_ref", lambda *a: ran.append(a))
    if torch.cuda.is_available():
        assert _tensor_of(BUILDERS[cls]()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            BUILDERS[cls]()
    assert not ran  # the plain version, the CPU's block, never ran
