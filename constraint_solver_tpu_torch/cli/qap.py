"""QAP CLI — the matmul-resident domain, no reference counterpart
(port of ``constraint_solver_tpu/cli/qap.py``).

Solves a random symmetric Taillard-style instance (models/qap.py) with the
same solver stack as the reference-mirroring CLIs; every LS iteration scores
the full n(n-1)/2 swap neighborhood.

Divergence from the JAX CLI: ``--platform {tpu,cpu}`` becomes ``--device
{cuda,cpu}``, default ``cuda``, with no check for a card and no fallback.
Flags, defaults, configuration, output lines and return code are the JAX
CLI's, including its two choices that ADVICE r5 questioned (ROADMAP C3), both
kept so that the same argv runs the same solver:

- ``--compact`` defaults on for every ``--size`` >= 512 on which
  ``--incremental`` is off, so ``--size 4096 --no-incremental`` runs the
  compact proposer (the JAX help text says "< 4096"; this one says what the
  code does).
- With ``--incremental`` the elite archive keeps its 16 entries per lane, and
  each archived state holds G and H: 16 × 2 × n² × 4 B of device memory per
  lane, 2.1 GB at n = 4096.

The host-oracle check of the best cost raises ``AssertionError`` as the JAX
CLI's ``assert`` does, and also under ``python -O``.

Usage:
    python -m constraint_solver_tpu_torch.cli.qap --size 64 --rounds 100
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="QAP example")
    parser.add_argument("--seed", "-s", default="42")
    parser.add_argument("--size", "-n", type=int, default=64)
    parser.add_argument("--instance-seed", type=int, default=0)
    parser.add_argument("--population", "-p", type=int, default=1)
    parser.add_argument("--rounds", type=int, default=100)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument(
        "--compact", action=argparse.BooleanOptionalAction, default=None,
        help="row-min candidate compaction (models/qap.py compact=True), "
        "identical winners; default: on for --size >= 512 unless "
        "--incremental is on (so also at --size >= 4096 with --no-incremental)",
    )
    parser.add_argument(
        "--incremental", action=argparse.BooleanOptionalAction, default=None,
        help="carry G/H in state with exact rank-2 swap updates "
        "(models/qap.py incremental=True): no per-iteration matmuls; "
        "default: on for --size >= 4096; each of the 16 archived solutions "
        "per lane holds G and H (16 x 2 x n^2 x 4 B: 2.1 GB per lane at "
        "n = 4096)",
    )
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)
    if args.incremental is None:
        args.incremental = args.size >= 4096
    if args.compact is None:
        args.compact = args.size >= 512 and not args.incremental

    import numpy as np

    from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
    from constraint_solver_tpu_torch.models.qap import (
        QAPSpec,
        make_qap_problem,
        qap_cost_naive,
    )
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    print("qap example")
    spec = QAPSpec.random(args.size, seed=args.instance_seed)
    problem = make_qap_problem(
        spec, compact=args.compact, incremental=args.incremental)
    config = SolverConfig(
        seed=args.seed,
        local_search_max_iterations=100,
        best_solutions_capacity=16,
        all_solutions_capacity=256,
        all_solution_iteration_expiry=10_000,
        iterated_local_search_max_iterations=args.rounds,
        max_allow_no_improvement_for=5,
    )
    t0 = time.time()
    if args.population > 1:
        solver = PopulationSolver(problem, config, population=args.population, device=args.device)
    else:
        solver = Solver(problem, config, device=args.device)
    solver.run()
    (hard, _), perm = solver.get_best_solution()
    if hasattr(perm, "p"):  # incremental QAPState carries (p, G, H)
        perm = perm.p
    wall = time.time() - t0

    # Cross-check the device score against the host oracle.
    flow, dist = spec.arrays()
    oracle = qap_cost_naive(flow, dist, np.asarray(perm))
    if abs(oracle - hard) >= 1e-3 * max(1.0, abs(oracle)):
        raise AssertionError((oracle, hard))
    if not args.quiet:
        print("result.permutation:", np.asarray(perm).tolist())
    print(f"result.cost: {hard:.0f}")
    print(f"stats: {solver.stats()} wall: {wall:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
