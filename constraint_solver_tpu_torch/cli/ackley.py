"""Ackley CLI — the framework's continuous test domain as a binary
(port of ``constraint_solver_tpu/cli/ackley.py``).

The reference keeps Ackley in-tree purely as the engine's test fixture
(reference local-search/src/ackley.rs; no binary).  This CLI exposes it as a
runnable example so the continuous-domain path has the same surface as the
discrete ones.

Divergence from the JAX CLI: ``--platform {tpu,cpu}`` becomes ``--device
{cuda,cpu}``, default ``cuda``, with no check for a card and no fallback.
Flags, defaults, configuration, output lines and return code are the JAX
CLI's.

Usage:
    python -m constraint_solver_tpu_torch.cli.ackley --dims 10
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Ackley-function example")
    parser.add_argument("--seed", "-s", default="42")
    parser.add_argument("--dims", "-d", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=1000)
    parser.add_argument("--population", "-p", type=int, default=1)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    import numpy as np

    from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
    from constraint_solver_tpu_torch.models.ackley import make_ackley_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    print("ackley local search example")
    # Engine-test hyperparameters (ref iterated_local_search.rs:283-323
    # drive the same domain to within 1e-2 of the optimum).
    config = SolverConfig(
        seed=args.seed,
        local_search_max_iterations=10_000,
        best_solutions_capacity=32,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=args.rounds,
        max_allow_no_improvement_for=10,
    )
    problem = make_ackley_problem(args.dims)
    t0 = time.time()
    if args.population > 1:
        solver = PopulationSolver(problem, config, population=args.population, device=args.device)
    else:
        solver = Solver(problem, config, device=args.device)
    solver.run()
    (value, _), x = solver.get_best_solution()
    wall = time.time() - t0
    print("result.x:", np.round(np.asarray(x), 4).tolist())
    print(f"result.value: {value:.6f}")
    print(f"stats: {solver.stats()} wall: {wall:.2f}s")
    return 0 if abs(value) <= 1e-2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
