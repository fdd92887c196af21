"""Iterated Local Search rounds and the single-lane driver
(port of ``constraint_solver_tpu/core/ils.py``).

One round, as in the JAX package: advance the round counter; a lane whose elite
best is already ``is_best`` only advances its counter; every ``restart_every``
rounds the current solution is replaced by a fresh random one; perturb
(intensify near elites, diversify otherwise); descend; insert the result into the
elite archive; accept {current: 1, new: 5, random elite: 1} (or greedy / SA for
portfolio lanes).

Divergences:

- the state carries no key: draws come from a ``Draws`` source, and
  ``ils_round`` calls ``draws.round_keys()`` where the JAX round splits its key;
- lanes run in lockstep, so the host knows the round number (``round_no``) and
  the restart is a Python ``if``, the JAX chunk program's ``lax.cond`` branch,
  without a sync;
- ``Solver`` is one lane of the batched engine (P = 1); its state keeps the lane
  axis, and ``get_best_solution`` drops it.  ``save``/``load`` also carry the
  draw source's state and the host round counter (``utils/checkpoint.py``).
  ``roofline`` counts one chunk of rounds run on a copy of the state, or on a
  fresh initial state once the lane has converged (``utils/roofline.py``),
  instead of cost-analysing a compiled program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from constraint_solver_tpu_torch.core.graphed import DescentGraphs
from constraint_solver_tpu_torch.core.history import EliteArchive, TabuRing
from constraint_solver_tpu_torch.core.local_search import LsParams, ls_execute
from constraint_solver_tpu_torch.core.problem import Problem
from constraint_solver_tpu_torch.ops.lex import lex_leq
from constraint_solver_tpu_torch.utils.checkpoint import load_into, run_chunks, save_state
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from constraint_solver_tpu_torch.utils.roofline import solver_roofline
from constraint_solver_tpu_torch.utils.tree import tree_map, tree_where


class IlsParams(NamedTuple):
    max_iterations: int
    max_allow_no_improvement_for: int
    restart_every: int = 50
    accept_weights: tuple = (1.0, 5.0, 1.0)  # {current, new, random elite}


class IlsState(NamedTuple):
    """The JAX ``IlsState`` without its key; every leaf has the lane axis first."""

    current_state: Any
    current_score: torch.Tensor         # float32[P, 2]
    current_fp: torch.Tensor            # int64[P, 2]
    elite: EliteArchive
    tabu: TabuRing
    round: torch.Tensor                 # int32[P]
    ls_iters_total: torch.Tensor        # int32[P]
    tabu_exhausted_total: torch.Tensor  # int32[P]
    accept_temp: torch.Tensor           # float32[P]: <0 reference, 0 greedy, >0 SA


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Engine hyperparameters, the JAX package's ``SolverConfig``.
    ``select_topk > 1`` turns on the noisy selection (``LsParams``)."""

    seed: str = "42"
    local_search_max_iterations: int = 10_000
    best_solutions_capacity: int = 32
    all_solutions_capacity: int = 512
    all_solution_iteration_expiry: int = 10_000
    iterated_local_search_max_iterations: int = 10_000
    max_allow_no_improvement_for: int = 5
    restart_every: int = 50
    tabu_exact_filter: bool | None = None
    select_topk: int = 0
    select_temp: float = 1.0

    # Exact-filter auto threshold: candidate width x ring capacity compares.
    _EXACT_FILTER_BUDGET = 2**21

    def ls_params(self, problem_width: int | None = None) -> LsParams:
        if self.tabu_exact_filter is not None:
            exact = self.tabu_exact_filter
        else:
            exact = (
                problem_width is not None
                and 0 < problem_width * self.all_solutions_capacity <= self._EXACT_FILTER_BUDGET
            )
        return LsParams(
            max_iterations=self.local_search_max_iterations,
            allow_no_improvement_for=self.max_allow_no_improvement_for,
            tabu_exact_filter=exact,
            tabu_forced=self.tabu_exact_filter is not None,
            select_topk=self.select_topk,
            select_temp=self.select_temp,
        )

    def ils_params(self) -> IlsParams:
        return IlsParams(
            max_iterations=self.iterated_local_search_max_iterations,
            max_allow_no_improvement_for=self.max_allow_no_improvement_for,
            restart_every=self.restart_every,
        )


def ils_init(problem: Problem, config: SolverConfig, draws, accept_temp) -> IlsState:
    """Initial state of ``draws.population`` lanes on ``draws.device``: a scored
    random solution, an empty elite archive and an empty tabu ring per lane.
    ``accept_temp`` is a float or a float32[P] tensor."""
    p, device = draws.population, draws.device
    state = problem.init(draws)
    zeros = torch.zeros((p,), dtype=torch.int32, device=device)
    return IlsState(
        current_state=state,
        current_score=problem.score(state),
        current_fp=problem.fingerprint(state),
        elite=EliteArchive.create(config.best_solutions_capacity, state),
        tabu=TabuRing.create(
            p, config.all_solutions_capacity, config.all_solution_iteration_expiry, device
        ),
        round=zeros,
        ls_iters_total=zeros,
        tabu_exhausted_total=zeros,
        accept_temp=torch.as_tensor(accept_temp, dtype=torch.float32, device=device).expand(p).clone(),
    )


def ils_round(
    problem: Problem,
    ls_params: LsParams,
    ils_params: IlsParams,
    st: IlsState,
    draws,
    round_no: int,
    graphs=None,
) -> IlsState:
    """One ILS round on every lane; ``round_no`` is the 1-based round number
    this call executes (every lane's ``round + 1``).  ``graphs``: the solver's
    ``DescentGraphs`` for the descent (``ls_execute``)."""
    rnd = st.round + 1
    best_score, _, _ = st.elite.get_best()
    done = st.elite.valid.any(dim=-1) & problem.is_best(best_score)

    draws.round_keys()
    if round_no % ils_params.restart_every == 0:
        cur_state = problem.init(draws)
        cur_score, cur_fp = problem.score(cur_state), problem.fingerprint(cur_state)
    else:
        cur_state, cur_score, cur_fp = st.current_state, st.current_score, st.current_fp

    perturbed = problem.perturb(cur_state, st.elite.contains_fp(cur_fp), draws)
    new_state, new_score, tabu, ls_iters, ls_exhausted = ls_execute(
        problem, ls_params, perturbed, st.tabu, draws, enabled=~done, graphs=graphs
    )
    new_fp = problem.fingerprint(new_state)
    elite = st.elite.insert(new_score, new_fp, new_state)

    acc = draws.accept(elite.valid, ils_params.accept_weights)
    e_score, e_fp, e_state = elite.take(acc.elite_idx)
    temp = st.accept_temp
    d_hard = new_score[:, 0] - cur_score[:, 0]
    p_metropolis = torch.where(
        temp > 0.0, torch.exp(-d_hard.clamp_min(0.0) / temp.clamp_min(1e-9)), 0.0
    )
    sa_take_new = lex_leq(new_score, cur_score) | (acc.u < p_metropolis)
    choice = torch.where(temp < 0.0, acc.choice, sa_take_new.long())  # 0 current, 1 new, 2 elite

    def pick(cur, new, eli):
        return tree_where(choice == 0, cur, tree_where(choice == 1, new, eli))

    out = IlsState(
        current_state=pick(cur_state, new_state, e_state),
        current_score=pick(cur_score, new_score, e_score),
        current_fp=pick(cur_fp, new_fp, e_fp),
        elite=elite,
        tabu=tabu,
        round=rnd,
        ls_iters_total=st.ls_iters_total + ls_iters,
        tabu_exhausted_total=st.tabu_exhausted_total + ls_exhausted,
        accept_temp=st.accept_temp,
    )
    # Converged lanes only advance their round counter.
    return tree_where(done, st._replace(round=rnd), out)


def to_host(tree: Any) -> Any:
    """A state tree with numpy leaves."""
    return tree_map(lambda x: x.cpu().numpy(), tree)


def score_tuple(score: torch.Tensor) -> tuple:
    s = score.cpu().numpy()
    return (float(s[0]), float(s[1]))


class Solver:
    """Round-based host driver for one trajectory (the JAX ``Solver``):
    ``execute_round``, ``run``, ``is_finished``, ``get_iteration_info``,
    ``get_best_solution``, ``get_best_score``, ``cancel``, ``stats``.

    ``device`` defaults to the card; ``draws`` to ``TorchDraws(config.seed, 1,
    device)``.  The solver owns its descents' CUDA graphs (``core/graphed.py``);
    ``_graphed=False`` runs them eagerly, to compare the two."""

    def __init__(self, problem: Problem, config: SolverConfig, device="cuda", draws=None, _graphed=True):
        self.problem = problem
        self.config = config
        self.device = torch.device(device)
        self.cancelled = False
        self._wall = 0.0
        self._round = 0
        self.draws = draws if draws is not None else TorchDraws(config.seed, 1, self.device)
        self.state = ils_init(problem, config, self.draws, -1.0)
        self._ls_params = config.ls_params(problem.width)
        self._ils_params = config.ils_params()
        self.graphs = DescentGraphs() if _graphed else None

    def execute_round(self) -> None:
        self._round += 1
        self.state = ils_round(
            self.problem, self._ls_params, self._ils_params, self.state, self.draws, self._round, self.graphs
        )

    def is_finished(self) -> bool:
        return self._round >= self.config.iterated_local_search_max_iterations

    def get_iteration_info(self) -> dict:
        return {"current": self._round, "total": self.config.iterated_local_search_max_iterations}

    def get_best_solution(self):
        """``((hard, soft), state)`` with the state's leaves as host numpy arrays."""
        score, _, state = self.state.elite.get_best()
        return score_tuple(score[0]), to_host(tree_map(lambda x: x[0], state))

    def get_best_score(self) -> tuple:
        return score_tuple(self.state.elite.get_best()[0][0])

    def _solved(self) -> bool:
        return bool(self.problem.is_best(self.state.elite.get_best()[0][0].cpu()))

    def cancel(self) -> None:
        self.cancelled = True

    def run(
        self,
        max_rounds: int | None = None,
        chunk: int = 16,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 200,
    ) -> None:
        """Run rounds until finished, solved or cancelled; the host reads the
        best score once per ``chunk`` rounds.  ``verbose`` prints the best and
        current scores per chunk; with ``checkpoint_path`` the solver saves
        itself every ``checkpoint_every`` rounds and at the end."""
        total = self.config.iterated_local_search_max_iterations
        if max_rounds is not None:
            total = min(total, self._round + max_rounds)
        if self._round > 0 and self._solved():
            total = self._round

        def advance(total):
            for _ in range(min(chunk, total - self._round)):
                self.execute_round()

        def report(score):
            cur = score_tuple(self.state.current_score[0])
            print(
                f"[{self.problem.name}] round {self._round}/{total} "
                f"best score: {score_tuple(score)} current score: {cur}"
            )

        run_chunks(
            self, total, advance, lambda: self.state.elite.get_best()[0][0].cpu(),
            lambda score: bool(self.problem.is_best(score)), report if verbose else None,
            checkpoint_path, checkpoint_every,
        )

    def save(self, path: str) -> None:
        """Snapshot the state, the draw source and the round counter
        (``utils/checkpoint.py``)."""
        meta = {"problem": self.problem.name, "seed": self.config.seed, "population": 1}
        save_state(path, self.state, meta, self.draws, self._round)

    def load(self, path: str) -> dict:
        """Resume from a ``save``d checkpoint of the same problem; returns its
        metadata.  Raises ``ValueError`` for another problem or a population
        checkpoint."""
        return load_into(self, path, 1)

    def stats(self) -> dict:
        iters = int(self.state.ls_iters_total.sum())
        moves = iters * self.problem.width
        out = {
            "rounds": self._round,
            "ls_iterations": iters,
            "moves_evaluated": moves,
            "tabu_retry_exhausted": int(self.state.tabu_exhausted_total.sum()),
        }
        if self._wall > 0:
            out["moves_per_sec"] = round(moves / self._wall)
        return out

    def roofline(self, chunk: int = 2) -> dict:
        """FLOP/s and memory rate of the measured solve against the card's
        peaks (``utils/roofline.py``): the work of ``chunk`` rounds, counted on
        a copy of the state (on a fresh initial state once the lane has
        converged), scaled by the rounds run over the solve's wall.  The
        solver's state and draw source are left as they were."""

        def advance(state, base, n):
            for i in range(n):
                state = ils_round(
                    self.problem, self._ls_params, self._ils_params, state, self.draws, base + 1 + i
                )
            return state

        return solver_roofline(self, advance, chunk, lambda: ils_init(self.problem, self.config, self.draws, -1.0))
