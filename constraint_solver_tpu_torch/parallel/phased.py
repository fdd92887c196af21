"""Phase-scheduled population solver (port of ``constraint_solver_tpu/parallel/phased.py``).

Different engine programs run over one population state as the search goes on:
the state does not depend on the program (descent length, bail, proposer and
neighborhood width are parameters of the program), so a phase switch hands the
same tensors to another ``ChunkProgram``.  Phase boundaries are round counts, so
trajectories are deterministic per seed; chunks never cross a boundary, and the
moves of a finished phase are counted at that phase's width.

Constraints on the phase list (checked at construction): every phase has the
same elite capacity, tabu capacity and tabu expiry (they shape the state), and
every phase but the last has an increasing ``until_round``.

Divergences from the JAX package: the JAX key travels inside the state handed
between phases; here the draws and the round counter live on the solver, so all
phases share **one** draw source and one host round counter (a fresh source per
phase would restart the stream from the seed at every boundary).  The state is
made once, by phase 0's problem and configuration, as the JAX solver uses phase
0's initial state.  ``mesh`` shards the lanes over its ``pop`` axis for every
phase, as ``PopulationSolver(mesh=)`` does: the handoff passes each rank's
share of the state from one program to the next, and every count and best is
global.  Every phase's program descends through phase 0's solver's CUDA graphs
(``core/graphed.py``): one graphed unit per phase's problem, freed with the
solver.
"""

from __future__ import annotations

from typing import NamedTuple

from constraint_solver_tpu_torch.core.ils import SolverConfig, score_tuple
from constraint_solver_tpu_torch.core.problem import Problem
from constraint_solver_tpu_torch.parallel.mesh import Mesh, use_mesh
from constraint_solver_tpu_torch.parallel.population import ChunkProgram, PopulationSolver
from constraint_solver_tpu_torch.utils.checkpoint import run_chunks


class Phase(NamedTuple):
    """One phase: run ``problem``/``config`` until the population's round
    counter reaches ``until_round`` (None = until the overall budget)."""

    problem: Problem
    config: SolverConfig
    until_round: int | None = None


class PhasedPopulationSolver:
    """The ``PopulationSolver`` driver API over a phase schedule.

    The total round budget is the last phase's
    ``iterated_local_search_max_iterations``; earlier phases end at their
    ``until_round``.  ``device`` defaults to the card; ``draws`` to phase 0's
    seed."""

    def __init__(
        self,
        phases: list[Phase],
        population: int,
        exchange_every: int = 10,
        k_exchange: int = 4,
        portfolio: str = "reference",
        cull_frac: float = 0.0,
        cull_rank: str = "lex",
        device="cuda",
        draws=None,
        mesh: Mesh | None = None,
    ):
        if not phases:
            raise ValueError("need at least one phase")
        caps = [
            (p.config.best_solutions_capacity, p.config.all_solutions_capacity, p.config.all_solution_iteration_expiry)
            for p in phases
        ]
        if len(set(caps)) != 1:
            raise ValueError(f"phases disagree on state-shaping capacities: {caps}")
        if any(p.until_round is None for p in phases[:-1]):
            raise ValueError("only the last phase may omit until_round")
        bounds = [p.until_round for p in phases[:-1]]
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"phase until_rounds must increase: {bounds}")
        self.phases = phases
        self.population = population
        self.cancelled = False
        self._wall = 0.0
        # Phase 0's solver holds the one state, draw source and round counter;
        # every phase runs its own chunk program on them.
        self._base = PopulationSolver(
            phases[0].problem, phases[0].config, population, exchange_every=exchange_every,
            k_exchange=k_exchange, portfolio=portfolio, cull_frac=cull_frac, cull_rank=cull_rank,
            device=device, draws=draws, mesh=mesh,
        )
        self.mesh = mesh
        self._programs = [
            ChunkProgram(
                p.problem, p.config.ls_params(p.problem.width), p.config.ils_params(),
                k_exchange, cull_frac, exchange_every, cull_rank, mesh, self._base.program.graphs,
            )
            for p in phases
        ]
        self.exchange_every = exchange_every
        # Moves evaluated in completed phases, and the iteration count at the
        # current phase's entry (widths differ per phase).
        self._moves_done = 0
        self._iters_at_entry = 0

    @property
    def state(self):
        return self._base.state

    @property
    def draws(self):
        return self._base.draws

    @property
    def _round(self) -> int:
        return self._base._round

    def _phase_index(self, rounds: int) -> int:
        for i, p in enumerate(self.phases[:-1]):
            if rounds < p.until_round:
                return i
        return len(self.phases) - 1

    def _iters(self) -> int:
        return self._base.stats()["ls_iterations"]

    def _advance(self, n: int) -> None:
        """Run ``n`` rounds of the current phase's program; if they end the
        phase, bank its moves at its own width."""
        base = self._base
        pi = self._phase_index(base._round)
        base.state = self._programs[pi].run(base.state, base.draws, base._round, n)
        base._round += n
        if self._phase_index(base._round) != pi:
            it = self._iters()
            self._moves_done += (it - self._iters_at_entry) * self.phases[pi].problem.width
            self._iters_at_entry = it

    def execute_round(self) -> None:
        self._advance(1)

    def is_finished(self) -> bool:
        return self._round >= self.phases[-1].config.iterated_local_search_max_iterations

    def get_iteration_info(self) -> dict:
        return {"current": self._round, "total": self.phases[-1].config.iterated_local_search_max_iterations}

    def get_best_score(self) -> tuple:
        return self._base.get_best_score()

    def get_best_solution(self):
        return self._base.get_best_solution()

    def cancel(self) -> None:
        self.cancelled = True

    def run(
        self,
        max_rounds: int | None = None,
        chunk: int | None = None,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 200,
    ) -> None:
        """Run chunks of the active phase's program; chunks never cross a
        phase boundary.  The solved-early exit follows the active phase's
        ``is_best``."""
        total = self.phases[-1].config.iterated_local_search_max_iterations
        if max_rounds is not None:
            total = min(total, self._round + max_rounds)

        def advance(total):
            pi = self._phase_index(self._round)
            phase_end = self.phases[pi].until_round if pi < len(self.phases) - 1 else total
            self._advance(min(chunk or self.exchange_every, phase_end - self._round, total - self._round))

        def report(score):
            print(
                f"[phased x P{self.population}] round {self._round}/{total} "
                f"phase {self._phase_index(self._round)} best score: {score_tuple(score)}"
            )

        with use_mesh(self.mesh):
            run_chunks(
                self, total, advance, lambda: self._base._best_score().cpu(),
                lambda score: bool(self.phases[self._phase_index(self._round)].problem.is_best(score)),
                report if verbose else None, checkpoint_path, checkpoint_every,
            )

    def stats(self) -> dict:
        rounds = self._round
        iters = self._iters()
        pi = self._phase_index(rounds)
        moves = self._moves_done + (iters - self._iters_at_entry) * self.phases[pi].problem.width
        out = {
            "rounds": rounds,
            "population": self.population,
            "phase": pi,
            "ls_iterations": iters,
            "moves_evaluated": moves,
            "tabu_retry_exhausted": self._base.stats()["tabu_retry_exhausted"],
        }
        if self._wall > 0:
            out["moves_per_sec"] = round(moves / self._wall)
        return out

    def save(self, path: str) -> None:
        """The base solver's checkpoint (rank 0 writes under a mesh) with the
        per-phase move accounting in its metadata."""
        base = self._base
        meta = {
            **base.checkpoint_meta(),
            "phased_moves_done": self._moves_done,
            "phased_iters_at_entry": self._iters_at_entry,
        }
        base.save(path, meta)

    def load(self, path: str) -> dict:
        """Resume a ``save``d run: the phase follows from the round counter,
        and the per-phase move accounting from the checkpoint."""
        meta = self._base.load(path)
        self._moves_done = int(meta.get("phased_moves_done", 0))
        self._iters_at_entry = int(meta.get("phased_iters_at_entry", 0))
        return meta
