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
  ``models/nqueens.py`` (``log_weights``), and the sample with each column's
  row and removed term in one call of ``ops/nqueens_sample.nqueens_sample``
  (K6 on the card; on the CPU its plain version, the stable sort and gathers).
- **One step as a CUDA graph** where the JAX package compiles the whole
  ``while_loop`` into one device program.  ``pmc_run`` and ``pmc_solve`` take
  a ``PMCGraphs`` holder (None: a fresh one for the call), which keeps one
  ``GraphedPMC`` per (n, P, ``p_accept``, ``sample_cols``, draw source, carry
  and table shapes).  A unit runs the eager loop on a static ``PMCState`` and a
  static ``limit`` filled at each call: its first step eagerly (that loads the
  kernel), its second as a capture of one step (``core/graphed.capture``, the
  draw source's generator registered, the unit's private pool) replayed at
  once, every later step as a replay.  The host reads whether any lane still
  runs at the eager loop's steps (every ``_DONE_CHECK_EVERY``), so no step
  runs that the eager loop would not run, and the generator's Philox offset
  and the kernel's launch counters end where the eager loop leaves them.  The
  sampled mode's log table is the unit's own device tensor, refilled from the
  host's at each call, so the graph's pointer stays valid.  The rule is
  ``core/graphed.eager_reason`` with no problem: a CUDA device, no mesh, no
  ``roofline`` count and a draw source whose generator is on the card
  (``TorchDraws(..., draw_device="cpu")`` and the tests' JAX-key draws stay
  eager).  ``ParallelMinConflictsSolver`` owns one holder for its lifetime;
  the private ``_graphed=False`` of the three entry points runs the eager loop,
  to compare the two.  A capture or replay that fails raises.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from constraint_solver_tpu_torch.core.graphed import Captured, cuda_capturer, eager_reason
from constraint_solver_tpu_torch.models.nqueens import NQState, build_state, default_log_weights, state_conflicts
from constraint_solver_tpu_torch.ops.nqueens_kernel import nqueens_neighborhood_scores
from constraint_solver_tpu_torch.ops.nqueens_sample import nqueens_sample
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from constraint_solver_tpu_torch.utils.tree import lane_where, tree_leaves, tree_map, tree_where

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
    conflicted = st.cs > 0
    dr = draws.pmc_step(n, a, conflicted, active, sample_cols is not None)

    if sample_cols is None:
        cols = torch.arange(n, device=rows.device).expand(p, n).contiguous()
        c, r, removed = cols.to(torch.int32), rows.to(torch.int32), st.cs
    else:
        # Gumbel top-A of the conflicted columns weighted by conflict count,
        # ties in index order as lax.top_k takes them, with each column's row
        # and removed term (its column score): one K6 call.  The sample's
        # col_valid and n_valid are not read.
        n_conflicted = conflicted.sum(dim=-1)
        s = nqueens_sample(st.cs, log_table, dr.gumbel, n_conflicted, n_conflicted, rows, st.rc, st.dc, st.ac, a)
        cols, c, r, removed = s.cols, s.c, s.r, s.removed
    _, best_score, best_row = nqueens_neighborhood_scores(
        st.rc, st.dc, st.ac, c, r, removed, state_conflicts(st)
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


def _active(carry: PMCState, limit: torch.Tensor) -> torch.Tensor:
    return (carry.score > 0) & (carry.steps < limit)


def _run_eager(carry: PMCState, draws, max_steps: int, p_accept: float, sample_cols, log_table) -> PMCState:
    limit = carry.steps + max_steps
    for i in range(max_steps):
        active = _active(carry, limit)
        if i % _DONE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        carry = tree_where(active, pmc_step(carry, draws, active, p_accept, sample_cols, log_table), carry)
    return carry


class GraphedPMC:
    """One (n, P, ``p_accept``, ``sample_cols``, draw source, shapes)'s step
    loop on a static carry, its step captured by ``capture`` (see the module
    docstring).  With ``capture=None`` every step runs eagerly on the static
    carry: the CPU tests hold that loop against the eager one."""

    def __init__(self, c0: PMCState, draws, p_accept: float, sample_cols, table, capture=None):
        self.draws, self.p_accept, self.sample_cols = draws, p_accept, sample_cols
        self.carry = tree_map(torch.empty_like, c0)
        self.limit = torch.empty_like(c0.steps)
        self.table = None if table is None else table.to(c0.score.device, copy=True)
        self._capture = capture
        self._warm = False
        self._step_graph: Captured | None = None
        self.capture_s = 0.0  # host seconds spent capturing

    def run(self, c0: PMCState, max_steps: int, table) -> PMCState:
        """The eager loop of ``pmc_run`` from carry ``c0``: the final carry."""
        torch._foreach_copy_(tree_leaves(self.carry), tree_leaves(c0))
        torch.add(self.carry.steps, max_steps, out=self.limit)
        if table is not None:
            self.table.copy_(table)
        for i in range(max_steps):
            if i % _DONE_CHECK_EVERY == 0 and not bool(_active(self.carry, self.limit).any()):
                break
            self._iteration()
        return tree_map(torch.clone, self.carry)

    def _step(self) -> None:
        """One step, written into the static carry for the lanes still running."""
        active = _active(self.carry, self.limit)
        new = pmc_step(self.carry, self.draws, active, self.p_accept, self.sample_cols, self.table)
        for dst, src in zip(tree_leaves(self.carry), tree_leaves(new)):
            torch.where(active.view(active.shape + (1,) * (dst.dim() - 1)), src, dst, out=dst)

    def _iteration(self) -> None:
        if self._capture is None or not self._warm:
            self._step()
            self._warm = True
            return
        if self._step_graph is None:
            t0 = time.perf_counter()
            self._step_graph = self._capture(self._step)
            self.capture_s += time.perf_counter() - t0
        self._step_graph.replay()


class PMCGraphs:
    """The graphed PMC step loops of one owner (a ``ParallelMinConflictsSolver``,
    or one ``pmc_run`` call): one ``GraphedPMC`` per (n, P, ``p_accept``,
    ``sample_cols``, draw source, carry and table shapes), made at first use.
    ``capturer`` makes a unit's capture function from (device, draws); None runs
    the units' steps eagerly (the CPU tests)."""

    def __init__(self, capturer: Callable | None = cuda_capturer):
        self._capturer = capturer
        self._units: dict = {}

    def applies(self, draws, device: torch.device) -> bool:
        return eager_reason(None, draws, device) is None

    def run(self, carry: PMCState, draws, max_steps: int, p_accept: float, sample_cols, table) -> PMCState:
        shapes = tuple((x.shape, x.dtype, x.device) for x in tree_leaves(carry))
        key = (p_accept, sample_cols, draws, shapes, None if table is None else table.shape)
        unit = self._units.get(key)
        if unit is None:
            device = carry.score.device
            capture = self._capturer(device, draws) if self._capturer is not None else None
            unit = self._units[key] = GraphedPMC(carry, draws, p_accept, sample_cols, table, capture)
        return unit.run(carry, max_steps, table)

    @property
    def capture_s(self) -> float:
        """Host seconds spent capturing, over every unit."""
        return sum(unit.capture_s for unit in self._units.values())


def pmc_run(
    carry: PMCState,
    draws,
    max_steps: int,
    p_accept: float = 0.7,
    sample_cols: int | None = None,
    log_weights=None,
    graphs: PMCGraphs | None = None,
    _graphed: bool = True,
) -> PMCState:
    """Continue every lane for up to ``max_steps`` more steps; a lane stops at 0
    conflicts.  ``log_weights``: float32[3n] table of log(k + 1e-4) for the
    sampled-column mode (default ``default_log_weights(n)``).  ``graphs``: the
    caller's ``PMCGraphs`` (None: a fresh one); where ``core/graphed``'s rule
    allows, the steps replay as CUDA graphs, bit for bit the eager loop."""
    n = carry.state.rows.shape[1]
    table = None
    if sample_cols is not None:
        table = default_log_weights(n) if log_weights is None else torch.tensor(log_weights, dtype=torch.float32)
        table = table.reshape(-1)
    device = carry.score.device
    graphs = PMCGraphs() if graphs is None else graphs
    if _graphed and graphs.applies(draws, device):
        return graphs.run(carry, draws, max_steps, p_accept, sample_cols, table)
    return _run_eager(carry, draws, max_steps, p_accept, sample_cols, None if table is None else table.to(device))


def pmc_solve(
    n: int,
    draws,
    max_steps: int = 5000,
    p_accept: float = 0.7,
    sample_cols: int | None = None,
    log_weights=None,
    graphs: PMCGraphs | None = None,
    _graphed: bool = True,
) -> PMCState:
    """Solve n-queens on ``draws.population`` lanes by parallel min-conflicts
    from random permutations, stopping at 0 conflicts or after ``max_steps``.
    ``sample_cols`` bounds each step's block to [A, n] (default: all n columns);
    ``graphs`` as in ``pmc_run``."""
    return pmc_run(pmc_init(n, draws), draws, max_steps, p_accept, sample_cols, log_weights, graphs, _graphed)


class ParallelMinConflictsSolver:
    """Driver with the ``Solver`` result surface: solves in the constructor and
    keeps the lane with the fewest conflicts (the first on ties).

    ``device`` defaults to the card; ``draws`` to ``TorchDraws(seed,
    population, device)``.  The solver owns its step loop's CUDA graphs
    (``graphs``, a ``PMCGraphs``); ``_graphed=False`` runs the eager loop, to
    compare the two."""

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
        _graphed: bool = True,
    ):
        self.n = board_size
        self.population = population
        self._block = (sample_cols or board_size) * board_size
        draws = draws if draws is not None else TorchDraws(seed, population, device)
        self.graphs = PMCGraphs() if _graphed else None
        out = pmc_solve(board_size, draws, max_steps, p_accept, sample_cols, log_weights, self.graphs, _graphed)
        lane = int(out.score.argmin())
        self._out = tree_map(lambda x: x[lane], out)

    def get_best_solution(self):
        """``((conflicts, 0.0), board state)`` with host numpy leaves."""
        return (float(self._out.score), 0.0), tree_map(lambda x: x.cpu().numpy(), self._out.state)

    def stats(self) -> dict:
        steps = int(self._out.steps)
        return {"steps": steps, "moves_evaluated": steps * self._block * max(1, self.population)}

