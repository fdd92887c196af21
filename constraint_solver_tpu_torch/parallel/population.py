"""Trajectory populations with elite exchange
(port of ``constraint_solver_tpu/parallel/population.py``).

P trajectories run as one lane-batched program, each with its own tabu ring and
elite archive.  At the end of a chunk, on the ``exchange_every`` round cadence,
the global lexicographic top-k of the lanes' best solutions is inserted into
every lane's archive, one entry after another (the order decides which slot is
the worst), and optionally the worst ``cull_frac`` of lanes restart from their
archive best.

Divergences: the state carries no keys (draws come from a ``Draws`` source made
from the seed, or given); the round number lives on the host, because lanes run
in lockstep, so the restart and the exchange cadence are Python branches without
a sync.  Not ported yet: the mesh (one device only), ``reseed_from_elites``,
``save``, ``load``, ``roofline`` and ``run``'s ``verbose`` and checkpoint
arguments.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from constraint_solver_tpu_torch.core.ils import (
    IlsParams,
    IlsState,
    SolverConfig,
    ils_init,
    ils_round,
    score_tuple,
    to_host,
)
from constraint_solver_tpu_torch.core.local_search import LsParams
from constraint_solver_tpu_torch.core.problem import Problem
from constraint_solver_tpu_torch.ops.lex import lex_argmin, lex_argsort, lex_top_k
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from constraint_solver_tpu_torch.utils.tree import lane_where, tree_map, tree_where


def portfolio_temps(population: int, mix: str = "reference", device="cpu") -> torch.Tensor:
    """Per-lane acceptance temperatures: "reference" is the 1:5:1 acceptance
    on every lane (-1); "mixed" is half reference, a quarter greedy (0) and a
    quarter SA with temperatures log-spaced in [0.5, 8]."""
    temps = np.full((population,), -1.0, np.float32)
    if mix != "reference":
        if mix != "mixed":
            raise ValueError(f"unknown portfolio {mix!r}")
        q = population // 4
        temps[:q] = 0.0
        if q > 0:
            temps[q : 2 * q] = np.logspace(np.log10(0.5), np.log10(8.0), num=q, dtype=np.float32)
    return torch.as_tensor(temps, device=device)


def population_init(
    problem: Problem, config: SolverConfig, draws, accept_temps: torch.Tensor | None = None
) -> IlsState:
    """Initial state of ``draws.population`` lanes on ``draws.device``."""
    if accept_temps is None:
        accept_temps = portfolio_temps(draws.population, device=draws.device)
    return ils_init(problem, config, draws, accept_temps)


def exchange_elites(
    states: IlsState, k_exchange: int, cull_frac: float = 0.0, cull_rank: str = "lex"
) -> IlsState:
    """Insert the global top-k of the lanes' bests into every lane's archive,
    then reset the worst ``cull_frac`` of lanes to their archive best."""
    scores, fps, bests = states.elite.get_best()
    leaves = list(bests)
    top = lex_top_k(scores, k_exchange, fps, *leaves)
    top_scores, top_fps, top_leaves = top[0], top[1], top[2:]
    p = scores.shape[0]
    elite = states.elite
    for i in range(k_exchange):
        elite = elite.insert(
            top_scores[i].expand(p, 2),
            top_fps[i].expand(p, 2),
            type(bests)(*(leaf[i].expand(p, *leaf.shape[1:]) for leaf in top_leaves)),
        )
    states = states._replace(elite=elite)

    n_cull = int(p * cull_frac)
    if cull_frac > 0.0 and n_cull > 0:
        cur = states.current_score
        if cull_rank == "lex":
            order = lex_argsort(cur)
        elif cull_rank == "hard":
            order = torch.sort(cur[:, 0], stable=True).indices
        else:
            raise ValueError(f"unknown cull_rank {cull_rank!r}")
        rank = torch.argsort(order)
        cull = rank >= p - n_cull
        b_score, b_fp, b_state = states.elite.get_best()
        states = states._replace(
            current_state=tree_where(cull, b_state, states.current_state),
            current_score=lane_where(cull, b_score, states.current_score),
            current_fp=lane_where(cull, b_fp, states.current_fp),
        )
    return states


def best_score_of(st: IlsState) -> torch.Tensor:
    """The global best score [2] over all lanes' archives."""
    scores = st.elite.get_best()[0]
    return scores[lex_argmin(scores)]


@dataclasses.dataclass(frozen=True)
class ChunkProgram:
    """The population's chunk of rounds (the JAX ``run_chunk`` and
    ``run_chunk_traced``)."""

    problem: Problem
    ls_params: LsParams
    ils_params: IlsParams
    k_exchange: int
    cull_frac: float
    exchange_every: int
    cull_rank: str = "lex"

    def _gated_exchange(self, st: IlsState, round_no: int) -> IlsState:
        """The exchange fires on the ``exchange_every`` round cadence, however
        the host chunks its calls."""
        if self.k_exchange <= 0:
            return st
        if self.exchange_every <= 1 or round_no % self.exchange_every == 0:
            return exchange_elites(st, self.k_exchange, self.cull_frac, self.cull_rank)
        return st

    def _round(self, st: IlsState, draws, round_no: int) -> IlsState:
        return ils_round(self.problem, self.ls_params, self.ils_params, st, draws, round_no)

    def run(self, st: IlsState, draws, base: int, n: int) -> IlsState:
        """Rounds ``base + 1 .. base + n``, then the gated exchange."""
        for i in range(n):
            st = self._round(st, draws, base + 1 + i)
        return self._gated_exchange(st, base + n)

    def run_traced(self, st: IlsState, draws, base: int, n: int):
        """Like ``run``, and also a float32[n, 3] device trace of (round,
        best hard, best soft) after every round; the trace draws nothing."""
        rows = []
        for i in range(n):
            st = self._round(st, draws, base + 1 + i)
            best = best_score_of(st)
            rows.append(torch.cat([torch.full((1,), float(base + 1 + i), device=best.device), best]))
        return self._gated_exchange(st, base + n), torch.stack(rows)


class PopulationSolver:
    """The ``Solver`` driver API over P parallel trajectories.

    ``draws`` defaults to ``TorchDraws(config.seed, population, device)``."""

    def __init__(
        self,
        problem: Problem,
        config: SolverConfig,
        population: int,
        exchange_every: int = 10,
        k_exchange: int = 4,
        portfolio: str = "reference",
        cull_frac: float = 0.0,
        cull_rank: str = "lex",
        device="cpu",
        draws=None,
    ):
        self.problem = problem
        self.config = config
        self.population = population
        self.exchange_every = exchange_every
        self.device = torch.device(device)
        self.cancelled = False
        self._wall = 0.0
        self._round = 0
        self.draws = draws if draws is not None else TorchDraws(config.seed, population, self.device)
        if self.draws.population != population:
            raise ValueError(f"draws are for {self.draws.population} lanes, population is {population}")
        self.state = population_init(
            problem, config, self.draws, portfolio_temps(population, portfolio, self.device)
        )
        self.program = ChunkProgram(
            problem, config.ls_params(problem.width), config.ils_params(),
            k_exchange, cull_frac, exchange_every, cull_rank,
        )

    def execute_round(self) -> None:
        """A 1-round chunk: it carries the gated elite exchange."""
        self.state = self.program.run(self.state, self.draws, self._round, 1)
        self._round += 1

    def execute_chunk_traced(self, n: int) -> np.ndarray:
        """Advance ``n`` rounds; returns the per-round (round, best hard, best
        soft) trace as a host float32[n, 3] array (the read is the sync)."""
        self.state, trace = self.program.run_traced(self.state, self.draws, self._round, n)
        self._round += n
        return trace.cpu().numpy()

    def is_finished(self) -> bool:
        return self._round >= self.config.iterated_local_search_max_iterations

    def get_iteration_info(self) -> dict:
        return {"current": self._round, "total": self.config.iterated_local_search_max_iterations}

    def get_best_score(self) -> tuple:
        return score_tuple(best_score_of(self.state))

    def get_best_solution(self):
        """Global best over all lanes' archives, as ``((hard, soft), state)``
        with the state's leaves as host numpy arrays."""
        scores, _, bests = self.state.elite.get_best()
        lane = lex_argmin(scores)
        return score_tuple(scores[lane]), to_host(tree_map(lambda x: x[lane], bests))

    def cancel(self) -> None:
        self.cancelled = True

    def _solved(self) -> bool:
        return bool(self.problem.is_best(best_score_of(self.state).cpu()))

    def run(self, max_rounds: int | None = None, chunk: int | None = None) -> None:
        """Run chunks of rounds until finished, solved or cancelled; the host
        reads the best score once per chunk."""
        chunk = chunk or self.exchange_every
        total = self.config.iterated_local_search_max_iterations
        if max_rounds is not None:
            total = min(total, self._round + max_rounds)
        if self._round > 0 and self._solved():
            total = self._round
        t0 = time.time()
        while not self.cancelled and self._round < total:
            n = min(chunk, total - self._round)
            self.state = self.program.run(self.state, self.draws, self._round, n)
            self._round += n
            if self._solved():
                break
        self._wall += time.time() - t0

    def stats(self) -> dict:
        iters = int(self.state.ls_iters_total.sum())
        moves = iters * self.problem.width
        out = {
            "rounds": self._round,
            "population": self.population,
            "ls_iterations": iters,
            "moves_evaluated": moves,
            "tabu_retry_exhausted": int(self.state.tabu_exhausted_total.sum()),
        }
        if self._wall > 0:
            out["moves_per_sec"] = round(moves / self._wall)
        return out
