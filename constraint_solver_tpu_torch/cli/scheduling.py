"""Employee-scheduling CLI, mirroring the reference binary
(port of ``constraint_solver_tpu/cli/scheduling.py``).

Reference: examples/employee-scheduling/src/main.rs — 7 employees, 31 days
starting 2022-05-09, no holidays (main.rs:11-22), hyperparameters at
main.rs:25-31, per-employee output at main.rs:53-62.

Divergence from the JAX CLI: ``--platform {tpu,cpu}`` becomes ``--device
{cuda,cpu}``, default ``cuda``, with no check for a card and no fallback.
Flags, defaults, configuration, output lines and return value are the JAX
CLI's.

Usage:
    python -m constraint_solver_tpu_torch.cli.scheduling [--employees 7] [--days 31]
"""

from __future__ import annotations

import argparse
import datetime
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Employee scheduling local search example")
    parser.add_argument("--seed", "-s", default="42")
    parser.add_argument("--start-date", default="2022-05-09")
    parser.add_argument("--days", type=int, default=31)
    parser.add_argument("--employees", "-e", type=int, default=7)
    parser.add_argument("--rounds", type=int, default=250)
    parser.add_argument(
        "--proposer", choices=["dense", "random", "rescore", "systematic"],
        default=None,
        help="neighborhood proposer (default: dense, every ChangeDay move as "
        "one block — the throughput path; random = the reference's window of "
        "random moves, the quality path with --population)")
    parser.add_argument(
        "--window-size", type=int, default=None,
        help="random/rescore proposers only: moves sampled per iteration "
        "(ref window_size=100); passing it without --proposer selects the "
        "reference's random proposer")
    parser.add_argument(
        "--select-topk", type=int, default=0,
        help="dense proposer: sample the applied move from the k best "
        "candidates (Gumbel over exp(-score/temp)) instead of the argmin "
        "(presets.scheduling_dense_quality uses 64)")
    parser.add_argument(
        "--select-temp", type=float, default=0.5,
        help="selection temperature for --select-topk (default 0.5)")
    parser.add_argument("--population", "-p", type=int, default=1)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint", default=None, metavar="PATH",
                        help="snapshot solver state here every "
                        "--checkpoint-every rounds; if PATH exists, resume "
                        "from it (single-trajectory and population modes)")
    parser.add_argument("--checkpoint-every", type=int, default=100)
    args = parser.parse_args(argv)

    import dataclasses

    from constraint_solver_tpu_torch.core.ils import Solver
    from constraint_solver_tpu_torch.models.scheduling import (
        ScheduleSpec,
        make_scheduling_problem,
    )
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver
    from constraint_solver_tpu_torch.utils import presets
    from constraint_solver_tpu_torch.utils.checkpoint import resume_and_run
    from constraint_solver_tpu_torch.utils.printing import (
        format_schedule,
        format_schedule_by_employee,
    )

    print("employee scheduling local search example")
    start = datetime.date.fromisoformat(args.start_date)
    end = start + datetime.timedelta(days=args.days - 1)
    spec = ScheduleSpec.from_dates(start, end, args.employees)
    # Reference hyperparameters (main.rs:25-31) via the preset.
    config = dataclasses.replace(
        presets.scheduling_cli(seed=args.seed),
        iterated_local_search_max_iterations=args.rounds,
        select_topk=args.select_topk,
        select_temp=args.select_temp,
    )
    # --window-size only shapes the random/rescore neighborhoods; giving it
    # without --proposer means the caller wants the reference's windowed
    # random proposer, not the dense block (where it would be a no-op).
    proposer = args.proposer or ("random" if args.window_size else "dense")
    problem = make_scheduling_problem(
        spec, window_size=args.window_size or 100, proposer=proposer)
    t0 = time.time()
    if args.population > 1:
        solver = PopulationSolver(problem, config, population=args.population, device=args.device)
    else:
        solver = Solver(problem, config, device=args.device)
    resume_and_run(solver, args.checkpoint, args.checkpoint_every)
    (hard, soft), assign = solver.get_best_solution()
    wall = time.time() - t0

    if not args.quiet:
        print("result.solution:")
        print(format_schedule(assign, start))
        print("---")
        print(format_schedule_by_employee(assign, start))
    print(f"result.score: hard {hard:.1f} soft {soft:.1f}")
    print(f"stats: {solver.stats()} wall: {wall:.2f}s")
    return hard


if __name__ == "__main__":
    main()
