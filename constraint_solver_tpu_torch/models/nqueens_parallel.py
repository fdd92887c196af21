"""Synchronous parallel min-conflicts (PMC) for N-Queens, batched over lanes
(port of ``constraint_solver_tpu/models/nqueens_parallel.py``).

Each step scores every row of every column (or of A Gumbel-sampled conflicted
columns) as one [A, n] block, takes each column's best row, applies the
improving ones at once, each with probability ``p_accept``, and falls back to
the single best move when that combined step does not improve, or to a random
kick of a conflicted column when no move improves.  Counters are rebuilt once
per step.  Every function takes lanes [P, ...]; ``pmc_run`` is the JAX
``vmap(while_loop)`` written out: one masked loop over all lanes, a stopped lane
keeps its state, and the host asks whether any lane still runs only every
``_DONE_CHECK_EVERY`` steps.

Divergences from the JAX package:

- **The block always goes through the kernel wrapper**
  (``ops/nqueens_kernel.nqueens_neighborhood_scores``): the CUDA kernel for a
  CUDA tensor, its plain version on the CPU; there is no ``use_pallas``.  Each
  column's best row and score are the kernel's ``row_arg`` / ``row_min``.  The
  JAX package's Pallas branch hands the kernel's tuple to ``jnp.argmin`` and
  crashes (ROADMAP C1); its XLA branch computes the same first-index argmin
  and minimum, so the port equals that branch bit for bit.
- **Draws** come from a ``Draws`` source (``permutation``, ``pmc_step``), not a
  key carried in ``PMCState``.
- **Both fallbacks are computed for every lane and selected**: the JAX package
  rebuilds behind ``lax.cond``; here ``build_state`` is an O(n) scatter, so the
  select costs one more rebuild and no host read.
- **Log weights from a table** for the sampled-column mode, as in
  ``models/nqueens.py`` (``log_weights``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.models.nqueens import NQState, build_state, default_log_weights, state_conflicts
from constraint_solver_tpu_torch.ops.nqueens_kernel import nqueens_neighborhood_scores
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from constraint_solver_tpu_torch.utils.tree import lane_where, tree_map, tree_where

_DONE_CHECK_EVERY = 8


class PMCState(NamedTuple):
    """The JAX ``PMCState`` without its key; every leaf has the lane axis first."""

    state: NQState
    score: torch.Tensor  # float32[P] total conflicts
    steps: torch.Tensor  # int32[P]


def pmc_init(n: int, draws) -> PMCState:
    """Random permutation boards for ``draws.population`` lanes."""
    st = build_state(draws.permutation(n))
    steps = torch.zeros((draws.population,), dtype=torch.int32, device=st.rows.device)
    return PMCState(state=st, score=state_conflicts(st), steps=steps)


def pmc_step(
    carry: PMCState,
    draws,
    active: torch.Tensor,
    p_accept: float,
    sample_cols: int | None,
    log_table: torch.Tensor | None = None,
) -> PMCState:
    """One PMC step for every lane (the caller keeps the stopped lanes' carry)."""
    st = carry.state
    rows = st.rows
    p, n = rows.shape
    a = n if sample_cols is None else sample_cols
    dr = draws.pmc_step(n, a, st.cs > 0, active, sample_cols is not None)

    if sample_cols is None:
        cols = torch.arange(n, device=rows.device).expand(p, n).contiguous()
        r, removed = rows, st.cs
    else:
        # Gumbel top-A of the conflicted columns weighted by conflict count; a
        # stable descending sort takes ties in index order, as lax.top_k does.
        logits = torch.where(st.cs > 0, log_table[st.cs.long()], -torch.inf)
        cols = torch.sort(logits + dr.gumbel, dim=-1, descending=True, stable=True).indices[:, :a]
        r, removed = rows.gather(1, cols), st.cs.gather(1, cols).contiguous()
    _, best_score, best_row = nqueens_neighborhood_scores(
        st.rc, st.dc, st.ac, cols.to(torch.int32), r.to(torch.int32).contiguous(), removed, state_conflicts(st)
    )
    best_row = best_row.long()

    improving = best_score < carry.score[:, None]
    stuck = ~improving.any(dim=-1)
    # Damped parallel acceptance: accepted columns take their best row.
    accept = improving & (dr.u < p_accept)
    rows_par = rows.scatter(1, cols, torch.where(accept, best_row, r))
    # Fallback: the single best sampled move (first index on ties).
    j_best = best_score.argmin(dim=-1, keepdim=True)
    rows_one = rows.scatter(1, cols.gather(1, j_best), best_row.gather(1, j_best))
    # Plateau escape: a random conflicted column to a random row.
    rows_kick = rows.scatter(1, dr.kick_col[:, None], dr.kick_row[:, None])

    st_par = build_state(rows_par)
    score_par = state_conflicts(st_par)
    par_good = ~stuck & (score_par < carry.score)
    st_fb = build_state(torch.where(stuck[:, None], rows_kick, rows_one))
    return PMCState(
        state=tree_where(par_good, st_par, st_fb),
        score=lane_where(par_good, score_par, state_conflicts(st_fb)),
        steps=carry.steps + 1,
    )


def pmc_run(
    carry: PMCState,
    draws,
    max_steps: int,
    p_accept: float = 0.7,
    sample_cols: int | None = None,
    log_weights=None,
) -> PMCState:
    """Continue every lane for up to ``max_steps`` more steps; a lane stops at 0
    conflicts.  ``log_weights``: float32[3n] table of log(k + 1e-4) for the
    sampled-column mode (default ``default_log_weights(n)``)."""
    n = carry.state.rows.shape[1]
    log_table = None
    if sample_cols is not None:
        table = default_log_weights(n) if log_weights is None else torch.tensor(log_weights, dtype=torch.float32)
        log_table = table.reshape(-1).to(carry.score.device)
    limit = carry.steps + max_steps
    for i in range(max_steps):
        active = (carry.score > 0) & (carry.steps < limit)
        if i % _DONE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        carry = tree_where(active, pmc_step(carry, draws, active, p_accept, sample_cols, log_table), carry)
    return carry


def pmc_solve(
    n: int,
    draws,
    max_steps: int = 5000,
    p_accept: float = 0.7,
    sample_cols: int | None = None,
    log_weights=None,
) -> PMCState:
    """Solve n-queens on ``draws.population`` lanes by parallel min-conflicts
    from random permutations, stopping at 0 conflicts or after ``max_steps``.
    ``sample_cols`` bounds each step's block to [A, n] (default: all n columns)."""
    return pmc_run(pmc_init(n, draws), draws, max_steps, p_accept, sample_cols, log_weights)


class ParallelMinConflictsSolver:
    """Driver with the ``Solver`` result surface: solves in the constructor and
    keeps the lane with the fewest conflicts (the first on ties).

    ``device`` defaults to the card; ``draws`` to ``TorchDraws(seed,
    population, device)``."""

    def __init__(
        self,
        board_size: int,
        seed: str = "42",
        max_steps: int = 5000,
        p_accept: float = 0.7,
        population: int = 1,
        sample_cols: int | None = None,
        device="cuda",
        draws=None,
        log_weights=None,
    ):
        self.n = board_size
        self.population = population
        self._block = (sample_cols or board_size) * board_size
        draws = draws if draws is not None else TorchDraws(seed, population, device)
        out = pmc_solve(board_size, draws, max_steps, p_accept, sample_cols, log_weights)
        lane = int(out.score.argmin())
        self._out = tree_map(lambda x: x[lane], out)

    def get_best_solution(self):
        """``((conflicts, 0.0), board state)`` with host numpy leaves."""
        return (float(self._out.score), 0.0), tree_map(lambda x: x.cpu().numpy(), self._out.state)

    def stats(self) -> dict:
        steps = int(self._out.steps)
        return {"steps": steps, "moves_evaluated": steps * self._block * max(1, self.population)}

