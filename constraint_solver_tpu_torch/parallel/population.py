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
a sync.  ``save``/``load`` also carry the draw source's state and the host round
counter (``utils/checkpoint.py``), and ``reseed_from_elites`` takes its archive
slots from ``draws.reseed_pick``.  ``roofline`` counts one chunk run on a copy
of the state (``utils/roofline.py``).

Under a mesh (``PopulationSolver(..., mesh=)``, ``parallel/mesh.py``) each rank
holds ``population / n_pop`` lanes, the ones at its ``pop`` coordinate, and
draws from a ``LaneSlice`` of the whole population's source, so a sharded run
equals the one-device run on the same seed bit for bit.  The exchange gathers
the lane bests and current scores over ``pop`` (one collective), takes the
global top-k with ties to the lower global lane, gathers the k winning states
from their owners (a second collective) and ranks the cull globally, as the
JAX ``exchange_elites(axis=)`` does.  ``get_best_score``, ``get_best_solution``
and ``stats`` return global values on every rank; ``save`` gathers every lane
to rank 0, which alone writes the file, in the one-device layout, and ``load``
reads it on every rank and keeps its lanes, so a checkpoint moves between a
sharded and a one-device solver of the same population.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constraint_solver_tpu_torch.core.graphed import DescentGraphs
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
from constraint_solver_tpu_torch.ops.lex import lex_argmin, lex_argsort
from constraint_solver_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    all_gather,
    all_gather_tree,
    all_reduce,
    all_reduce_tree,
    use_mesh,
)
from constraint_solver_tpu_torch.utils.checkpoint import load_into, run_chunks, save_state
from constraint_solver_tpu_torch.utils.draws import LaneSlice, TorchDraws
from constraint_solver_tpu_torch.utils.roofline import solver_roofline
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
    states: IlsState, k_exchange: int, cull_frac: float = 0.0, cull_rank: str = "lex", axis: Axis | None = None
) -> IlsState:
    """Insert the global top-k of the lanes' bests into every lane's archive,
    then reset the worst ``cull_frac`` of lanes to their archive best.  With
    ``axis`` the lanes are this rank's share of a population sharded over that
    mesh axis: the top-k and the cull ranks are taken over every rank's lanes."""
    scores, fps, bests = states.elite.get_best()
    p = scores.shape[0]
    cur = states.current_score
    index = 0
    if axis is not None:  # every rank's lanes, in rank order
        scores, fps, cur = all_gather_tree((scores, fps, cur), axis)
        index = axis.index
    top = lex_argsort(scores)[:k_exchange]  # lex_top_k's order, for any state tree
    top_scores, top_fps = scores[top], fps[top]
    # Each winner's state from the rank that holds its lane, zeros elsewhere.
    mine = (top // p) == index
    local = torch.where(mine, top % p, 0)
    top_bests = tree_map(lambda x: lane_where(mine, x[local], torch.zeros_like(x[local])), bests)
    if axis is not None:
        top_bests = all_reduce_tree(top_bests, axis)
    elite = states.elite
    for i in range(top.shape[0]):
        elite = elite.insert(
            top_scores[i].expand(p, 2),
            top_fps[i].expand(p, 2),
            tree_map(lambda leaf: leaf[i].expand(p, *leaf.shape[1:]), top_bests),
        )
    states = states._replace(elite=elite)

    n_total = cur.shape[0]
    n_cull = int(n_total * cull_frac)
    if cull_frac > 0.0 and n_cull > 0:
        if cull_rank == "lex":
            order = lex_argsort(cur)
        elif cull_rank == "hard":
            order = torch.sort(cur[:, 0], stable=True).indices
        else:
            raise ValueError(f"unknown cull_rank {cull_rank!r}")
        rank = torch.argsort(order)[index * p : (index + 1) * p]
        cull = rank >= n_total - n_cull
        b_score, b_fp, b_state = states.elite.get_best()
        states = states._replace(
            current_state=tree_where(cull, b_state, states.current_state),
            current_score=lane_where(cull, b_score, states.current_score),
            current_fp=lane_where(cull, b_fp, states.current_fp),
        )
    return states


def pop_axis(mesh: Mesh | None) -> Axis | None:
    """The mesh's ``pop`` axis, if it has one."""
    return mesh.axis("pop") if mesh is not None and "pop" in mesh.axis_names else None


def best_score_of(st: IlsState, axis: Axis | None = None) -> torch.Tensor:
    """The global best score [2] over all lanes' archives (every rank's along
    ``axis``)."""
    scores = st.elite.get_best()[0]
    if axis is not None:
        scores = all_gather(scores, axis)
    return scores[lex_argmin(scores)]


@dataclasses.dataclass(frozen=True)
class ChunkProgram:
    """The population's chunk of rounds (the JAX ``run_chunk`` and
    ``run_chunk_traced``); under ``mesh`` the rounds run with it active and the
    exchange goes over its ``pop`` axis.  ``graphs``: the solver's
    ``DescentGraphs`` (``core/graphed.py``) for its descents."""

    problem: Problem
    ls_params: LsParams
    ils_params: IlsParams
    k_exchange: int
    cull_frac: float
    exchange_every: int
    cull_rank: str = "lex"
    mesh: Mesh | None = None
    graphs: DescentGraphs | None = None

    def _gated_exchange(self, st: IlsState, round_no: int) -> IlsState:
        """The exchange fires on the ``exchange_every`` round cadence, however
        the host chunks its calls."""
        if self.k_exchange <= 0:
            return st
        if self.exchange_every <= 1 or round_no % self.exchange_every == 0:
            return exchange_elites(st, self.k_exchange, self.cull_frac, self.cull_rank, pop_axis(self.mesh))
        return st

    def _round(self, st: IlsState, draws, round_no: int) -> IlsState:
        return ils_round(self.problem, self.ls_params, self.ils_params, st, draws, round_no, self.graphs)

    def run(self, st: IlsState, draws, base: int, n: int) -> IlsState:
        """Rounds ``base + 1 .. base + n``, then the gated exchange."""
        with use_mesh(self.mesh):
            for i in range(n):
                st = self._round(st, draws, base + 1 + i)
            return self._gated_exchange(st, base + n)

    def run_traced(self, st: IlsState, draws, base: int, n: int):
        """Like ``run``, and also a float32[n, 3] device trace of (round,
        best hard, best soft) after every round; the trace draws nothing."""
        rows = []
        with use_mesh(self.mesh):
            for i in range(n):
                st = self._round(st, draws, base + 1 + i)
                best = best_score_of(st, pop_axis(self.mesh))
                rows.append(torch.cat([torch.full((1,), float(base + 1 + i), device=best.device), best]))
            return self._gated_exchange(st, base + n), torch.stack(rows)


class PopulationSolver:
    """The ``Solver`` driver API over P parallel trajectories.

    ``device`` defaults to the card.  ``draws`` defaults to
    ``TorchDraws(config.seed, population, device)``; it may be a source for the
    whole population or, under a mesh, one for this rank's lanes.  ``mesh``
    shards the lanes over its ``pop`` axis (see the module docstring); every
    rank of the mesh's world builds the solver and makes the same calls.  The
    solver owns its descents' CUDA graphs (``core/graphed.py``);
    ``_graphed=False`` runs them eagerly, to compare the two."""

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
        device="cuda",
        draws=None,
        mesh: Mesh | None = None,
        _graphed: bool = True,
    ):
        self.problem = problem
        self.config = config
        self.population = population
        self.exchange_every = exchange_every
        self.device = torch.device(device)
        self.mesh = mesh
        self.cancelled = False
        self._wall = 0.0
        self._round = 0
        pop = pop_axis(mesh)
        n_pop = pop.size if pop is not None else 1
        if population % n_pop:
            raise ValueError(f"population {population} must divide over the pop axis ({n_pop} shards)")
        self.local_population = population // n_pop
        self._lo = (pop.index if pop is not None else 0) * self.local_population
        lanes = slice(self._lo, self._lo + self.local_population)
        draws = draws if draws is not None else TorchDraws(config.seed, population, self.device)
        if draws.population == population and self.local_population < population:
            draws = LaneSlice(draws, lanes.start, lanes.stop)
        if draws.population != self.local_population:
            raise ValueError(f"draws are for {draws.population} lanes, population is {population}")
        self.draws = draws
        self.state = population_init(
            problem, config, self.draws, portfolio_temps(population, portfolio, self.device)[lanes]
        )
        self.program = ChunkProgram(
            problem, config.ls_params(problem.width), config.ils_params(),
            k_exchange, cull_frac, exchange_every, cull_rank, mesh, DescentGraphs() if _graphed else None,
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

    def _best_score(self) -> torch.Tensor:
        return best_score_of(self.state, pop_axis(self.mesh))

    def get_best_score(self) -> tuple:
        return score_tuple(self._best_score())

    def _full_state(self, state):
        """A state tree of this rank's lanes with every position of the
        solution (the date-sharded solver gathers its days here)."""
        return state

    def get_best_solution(self):
        """Global best over all lanes' archives, as ``((hard, soft), state)``
        with the state's leaves as host numpy arrays."""
        scores, _, bests = self.state.elite.get_best()
        lane = lex_argmin(scores)
        score, best = tree_map(lambda x: x[lane][None], (scores, bests))
        pop = pop_axis(self.mesh)
        if pop is not None:
            # Each rank's best, lowest lane first among ties: the global best
            # is the first best of these in rank order.
            score, best = all_gather_tree((score, best), pop)
            pick = lex_argmin(score)
            score, best = tree_map(lambda x: x[pick][None], (score, best))
        return score_tuple(score[0]), to_host(tree_map(lambda x: x[0], self._full_state(best)))

    def cancel(self) -> None:
        self.cancelled = True

    def _solved(self) -> bool:
        return bool(self.problem.is_best(self._best_score().cpu()))

    def run(
        self,
        max_rounds: int | None = None,
        chunk: int | None = None,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 200,
    ) -> None:
        """Run chunks of rounds until finished, solved or cancelled; the host
        reads the best score once per chunk.  ``verbose`` prints the best and
        the lexicographically best current score per chunk; with
        ``checkpoint_path`` the solver saves itself every ``checkpoint_every``
        rounds and at the end.  Under a mesh a ``cancel`` on any rank stops
        every rank at the same chunk."""
        chunk = chunk or self.exchange_every
        total = self.config.iterated_local_search_max_iterations
        if max_rounds is not None:
            total = min(total, self._round + max_rounds)
        if self._round > 0 and self._solved():
            total = self._round

        def advance(total):
            n = min(chunk, total - self._round)
            self.state = self.program.run(self.state, self.draws, self._round, n)
            self._round += n

        def report(score):
            cur = self.state.current_score
            print(
                f"[{self.problem.name} xP{self.population}] round {self._round}/{total} "
                f"best score: {score_tuple(score)} current score: {score_tuple(cur[lex_argmin(cur)])}"
            )

        with use_mesh(self.mesh):
            run_chunks(
                self, total, advance, lambda: self._best_score().cpu(),
                lambda score: bool(self.problem.is_best(score)), report if verbose else None,
                checkpoint_path, checkpoint_every,
            )

    def roofline(self, chunk: int = 2) -> dict:
        """FLOP/s and memory rate of the measured solve against the card's
        peaks, all lanes and the gated exchange included: see
        ``Solver.roofline``.  Under a mesh every rank runs the counted chunk
        and the counts are summed over ranks."""

        def advance(state, base, n):
            return self.program.run(state, self.draws, base, n)

        def init():
            return population_init(self.problem, self.config, self.draws, self.state.accept_temp)

        return solver_roofline(self, advance, chunk, init)

    def reseed_from_elites(self) -> None:
        """Restart every lane's current solution from a random entry of its
        elite archive (lanes with an empty archive keep theirs)."""
        st = self.state
        score, fp, state = st.elite.take(self.draws.reseed_pick(st.elite.valid))
        has = st.elite.valid.any(dim=-1)
        self.state = st._replace(
            current_state=tree_where(has, state, st.current_state),
            current_score=lane_where(has, score, st.current_score),
            current_fp=lane_where(has, fp, st.current_fp),
        )

    def checkpoint_meta(self) -> dict:
        """What ``load`` checks a checkpoint against."""
        return {"problem": self.problem.name, "seed": self.config.seed, "population": self.population}

    def _dense_state(self, state):
        """The whole population's state in the one-device layout (a
        collective under a mesh)."""
        pop = pop_axis(self.mesh)
        return all_gather_tree(state, pop) if pop is not None else state

    def _shard_state(self, state):
        """This rank's share of a whole population's state (``_dense_state``'s
        inverse)."""
        lanes = slice(self._lo, self._lo + self.local_population)
        return tree_map(lambda x: x[lanes], state)

    def save(self, path: str, meta: dict | None = None) -> None:
        """Snapshot every lane's state, the draw source and the round counter
        (``utils/checkpoint.py``), with ``meta`` (default
        ``checkpoint_meta()``).  Under a mesh rank 0 writes every rank's lanes
        and the other ranks return once the file is written."""
        if self.mesh is not None and self.local_population < self.population and not isinstance(self.draws, LaneSlice):
            raise ValueError("a sharded checkpoint holds one draw source: give the solver one for the whole population")
        state = self._dense_state(self.state)
        if self.mesh is None or self.mesh.world.index == 0:
            save_state(path, state, meta or self.checkpoint_meta(), self.draws, self._round)
        if self.mesh is not None:
            all_reduce(torch.zeros(1, device=self.mesh.device), self.mesh.world)  # a barrier: the file is there for load

    def load(self, path: str) -> dict:
        """Resume from a ``save``d checkpoint of the same problem and
        population, sharded or not; returns its metadata.  Raises
        ``ValueError`` for another problem, another population or lanes out of
        lockstep."""
        return load_into(self, path, self.population, self._shard_state)

    def stats(self) -> dict:
        totals = torch.stack([self.state.ls_iters_total.long().sum(), self.state.tabu_exhausted_total.long().sum()])
        pop = pop_axis(self.mesh)
        if pop is not None:
            totals = all_reduce(totals, pop)
        iters, exhausted = (int(x) for x in totals)
        moves = iters * self.problem.width
        out = {
            "rounds": self._round,
            "population": self.population,
            "ls_iterations": iters,
            "moves_evaluated": moves,
            "tabu_retry_exhausted": exhausted,
        }
        if self._wall > 0:
            out["moves_per_sec"] = round(moves / self._wall)
        return out
