"""Diagram layout CLI — solve box placement, route connectors in C++
(port of ``constraint_solver_tpu/cli/diagram.py``).

The reference's diagram binary only renders a hard-coded 3x3 grid demo
(reference examples/diagram/src/main.rs:158-236); its solver integration is
two empty structs (main.rs:7-9).  This CLI is the finished pipeline: the ILS
engine lays out the boxes (models/diagram_layout.py), then the native sweep
builds the visibility graph and Dijkstra routes every connector
(diagram/route.py), emitting an SVG.

Divergence from the JAX CLI: ``--platform {tpu,cpu}`` becomes ``--device
{cuda,cpu}``, default ``cuda``, with no check for a card and no fallback.
Flags, defaults, configuration, output lines and return code are the JAX
CLI's.

Usage:
    python -m constraint_solver_tpu_torch.cli.diagram --boxes 9 --edges 8 \
        --grid 12 --svg layout.svg
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Diagram layout example")
    parser.add_argument("--seed", "-s", default="42")
    parser.add_argument("--boxes", "-b", type=int, default=9)
    parser.add_argument("--edges", "-e", type=int, default=8)
    parser.add_argument("--grid", "-g", type=int, default=12)
    parser.add_argument("--max-size", type=int, default=3)
    parser.add_argument("--chain", action="store_true",
                        help="path-connected uniform boxes (demo instance)")
    parser.add_argument("--population", "-p", type=int, default=1)
    parser.add_argument("--rounds", type=int, default=200)
    parser.add_argument("--svg", default=None, help="write routed SVG here")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
    from constraint_solver_tpu_torch.models.diagram_layout import (
        DiagramLayoutSpec,
        layout_to_boxes,
        make_diagram_layout_problem,
    )
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    print("diagram layout example")
    if args.chain:
        spec = DiagramLayoutSpec.chain(args.boxes, args.grid)
    else:
        spec = DiagramLayoutSpec.random(
            args.boxes, args.edges, args.grid, seed=0, max_size=args.max_size
        )
    problem = make_diagram_layout_problem(spec)
    config = SolverConfig(
        seed=args.seed,
        local_search_max_iterations=200,
        best_solutions_capacity=32,
        all_solutions_capacity=512,
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
    (hard, soft), best_pos = solver.get_best_solution()
    wall = time.time() - t0
    print(f"result.score: hard={int(hard)} overlaps, "
          f"soft={soft:.1f} total connector length (grid cells)")
    print(f"stats: {solver.stats()} wall: {wall:.2f}s")

    if args.svg:
        from constraint_solver_tpu_torch.diagram.route import render_routed

        boxes = layout_to_boxes(spec, best_pos)
        svg = render_routed(boxes, list(spec.edges), path=args.svg)
        print(f"routed SVG: {len(svg)} bytes -> {args.svg}")
    elif not args.quiet:
        import numpy as np

        print("positions:", np.asarray(best_pos).tolist())
    return int(hard)


if __name__ == "__main__":
    raise SystemExit(0 if main() == 0 else 1)
