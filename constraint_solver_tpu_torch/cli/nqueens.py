"""N-Queens CLI, mirroring the reference binary
(port of ``constraint_solver_tpu/cli/nqueens.py``).

Reference: examples/nqueens/src/main.rs — clap args ``--seed`` (default "42")
and ``--board-size`` (default 8) at main.rs:97-125; fixed hyperparameters at
main.rs:129-135.  Extras: ``--population`` runs a population of trajectories,
``--algo pmc`` parallel min-conflicts.

Divergences from the JAX CLI: ``--platform {tpu,cpu}`` becomes ``--device
{cuda,cpu}``, default ``cuda``, with no check for a card and no fallback
(without one the default raises); there is no ``use_pallas``: the tensors'
device picks the scoring kernel (the CUDA kernel on the card, its plain
version on the CPU).  Flags, defaults, configuration, output lines and return
codes are the JAX CLI's.

Usage:
    python -m constraint_solver_tpu_torch.cli.nqueens --seed 42 --board-size 8
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Local search N-Queens example")
    parser.add_argument("--seed", "-s", default="42", help="random seed, any string")
    parser.add_argument("--board-size", "-b", type=int, default=8)
    parser.add_argument("--population", "-p", type=int, default=1,
                        help="parallel ILS trajectories")
    parser.add_argument("--algo", choices=["ils", "pmc"], default="ils",
                        help="ils = reference-style iterated local search; "
                        "pmc = synchronous parallel min-conflicts")
    parser.add_argument("--rounds", type=int, default=10_000,
                        help="max ILS rounds (ref: 10_000)")
    parser.add_argument("--pmc-sample-cols", type=int, default=None,
                        help="PMC huge-board mode: score [A, n] sampled "
                        "columns per step instead of the full [n, n] block "
                        "(default 1024 at n >= 4096)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint", default=None, metavar="PATH",
                        help="snapshot solver state here every "
                        "--checkpoint-every rounds; if PATH exists, resume "
                        "from it (ils algos; not pmc)")
    parser.add_argument("--checkpoint-every", type=int, default=200)
    args = parser.parse_args(argv)

    from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils.printing import format_board

    print("local search n-queens example")
    n = args.board_size
    # Reference hyperparameters (main.rs:129-135); window = 5n becomes the
    # sampled-columns x all-rows dense neighborhood.
    config = SolverConfig(
        seed=args.seed,
        local_search_max_iterations=10_000,
        best_solutions_capacity=32,
        all_solutions_capacity=512,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=args.rounds,
        max_allow_no_improvement_for=5,
    )
    problem = make_nqueens_problem(n)
    t0 = time.time()
    if args.algo == "pmc":
        from constraint_solver_tpu_torch.models.nqueens_parallel import (
            ParallelMinConflictsSolver,
        )

        if args.checkpoint:
            print("warning: --checkpoint is ignored with --algo pmc "
                  "(pmc runs are single-dispatch chunks, not resumable)")
        sample_cols = args.pmc_sample_cols
        if sample_cols is None and n >= 4096:
            # The JAX CLI's default, kept so that the same argv runs the same
            # algorithm: the full [n, n] block per step is n² scores (64 MB at
            # n = 4096) for one applied move per column.
            sample_cols = 1024
        solver = ParallelMinConflictsSolver(
            n,
            seed=args.seed,
            population=args.population,
            sample_cols=sample_cols,
            device=args.device,
        )
    else:
        from constraint_solver_tpu_torch.utils.checkpoint import resume_and_run

        if args.population > 1:
            solver = PopulationSolver(
                problem, config, population=args.population, device=args.device
            )
        else:
            solver = Solver(problem, config, device=args.device)
        resume_and_run(solver, args.checkpoint, args.checkpoint_every)
    (hard, _soft), best_state = solver.get_best_solution()
    wall = time.time() - t0

    if not args.quiet:
        print("result.solution:")
        print(format_board(best_state.rows))
    print(f"result.score: {int(hard)}")
    stats = solver.stats()
    print(f"stats: {stats} wall: {wall:.2f}s")
    return int(hard)


if __name__ == "__main__":
    raise SystemExit(0 if main() == 0 else 1)
