"""Date-axis sharded solving (port of ``constraint_solver_tpu/parallel/seq_solver.py``).

A schedule too long for one device solves with its days sharded over the
``seq`` axis of a mesh (``parallel/mesh.py``): every solution, the current one
and every archived one, is the rank's slice int64[P, ⌈D/S⌉] of days (the last
rank's padding days hold -1 everywhere).  Scores, fingerprints, tabu rings,
counters and draws are replicated: every rank of a ``seq`` group computes the
same values.  The engine (``core/``) runs unchanged; the problem's functions
hold the collectives:

- ``neighborhood`` samples the W moves with the one-device sampler
  (``sample_random_moves``; the ranks of a group draw the same numbers).  One
  ``all_reduce`` sums, in one flat buffer, the employee-level counts, the old
  employees of every move's two days (each from the rank that owns the day,
  exact 0 elsewhere) and the 13-day halos each rank sends its neighbours.  Each
  move's 27-day region deltas (``region_deltas``, the one-device function) come
  from the rank that owns the changed day, masked to exact 0.0 elsewhere, and a
  second ``all_reduce`` sums them.  The aggregate deltas (H1, S2–S4) are then
  finished on every rank with the one-device formulas, so every score is the
  one-device ``proposer="random"`` score bit for bit (every term is a small
  integer in float32).  The moves carry their resolved old employees, so
  ``move_fp`` and ``apply_move`` need no collective.
- ``score`` is the halo scorer of ``parallel/seq_shard.py``; ``fingerprint``
  XORs every rank's partial fingerprint (one gather of [P, 2] per rank);
  ``init`` and ``perturb`` draw for the whole day vector with the one-device
  functions (``perturb`` gathers it once per round) and keep the rank's days.

So a sharded solve follows the trajectory of the one-device solver with the
random proposer on the same seed, bit for bit.  ``SeqShardedSolver`` is the
``PopulationSolver`` over a (pop, seq) mesh: lanes over ``pop``, days over
``seq``, with the elite exchange over ``pop`` (the JAX version runs it outside
its ``shard_map`` as plain sharded code: the same result).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem
from constraint_solver_tpu_torch.models.scheduling import (
    PAD,
    REG,
    ScheduleSpec,
    _make_perturb,
    _one_hot,
    _swap_fp_delta_planes,
    region_deltas,
    s2_of,
    s34_of,
    sample_random_moves,
)
from constraint_solver_tpu_torch.ops.fingerprint import _xor_reduce, fp_update, position_hash
from constraint_solver_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.parallel.seq_shard import (
    DayTables,
    aggregates,
    day_tables,
    finish_aggregates,
    local_days,
    sharded_score,
)


class SeqMoves(NamedTuple):
    """The random window's moves [P, W] with the old employees of their days
    (resolved once, in the neighborhood's collective)."""

    is_swap: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    new_emp: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor


def make_seq_scheduling_problem(spec: ScheduleSpec, mesh: Mesh, axis: str = "seq", window_size: int = 100) -> Problem:
    """The scheduling problem with the random proposer, its days sharded over
    ``mesh``'s ``axis``: the state is this rank's slice int64[P, local].  Raises
    ``ValueError`` when a rank would hold fewer than 13 days."""
    ax = mesh.axis(axis)
    d_days, n_emp, w_size = spec.num_days, spec.num_employees, window_size
    local = local_days(spec, ax.size)
    d_pad = local * ax.size
    start = ax.index * local
    tables: dict[torch.device, DayTables] = {}
    perturb_dense = _make_perturb(d_days, n_emp)

    def tab(device) -> DayTables:
        if device not in tables:
            tables[device] = day_tables(spec, d_pad, device)
        return tables[device]

    def mine(full: torch.Tensor) -> torch.Tensor:
        """This rank's days of whole assignments [P, D]."""
        return torch.cat([full, full.new_full((full.shape[0], d_pad - d_days), -1)], dim=1)[:, start : start + local]

    def whole(a_loc: torch.Tensor) -> torch.Tensor:
        """Every rank's days, [P, D] (one collective)."""
        return all_gather(a_loc, ax, dim=1)[:, :d_days]

    def init(draws):
        return mine(draws.assignment(d_days, n_emp))

    def score(a_loc):
        return sharded_score(a_loc, tab(a_loc.device), ax, d_days, n_emp)

    def is_best(s):
        return (s[..., 0] == 0) & (s[..., 1] == 0)

    def fingerprint(a_loc):
        g = start + torch.arange(local, device=a_loc.device)
        h = torch.where((g < d_days)[:, None], position_hash(g.expand(a_loc.shape), a_loc), 0)
        parts = all_gather(_xor_reduce(h), ax, dim=1)  # [P, S·2]
        return _xor_reduce(parts.view(parts.shape[0], ax.size, 2))

    def exchange(a_loc, sums: torch.Tensor):
        """One all_reduce: ``sums`` [P, m] summed over the axis, and the halos
        (the 13 days before and after this rank's slice, -1 off the schedule)."""
        p = a_loc.shape[0]
        halo = a_loc.new_zeros((p, ax.size, 2, PAD))
        halo[:, (ax.index + 1) % ax.size, 0] = a_loc[:, -PAD:]  # the successor's left halo
        halo[:, (ax.index - 1) % ax.size, 1] = a_loc[:, :PAD]   # the predecessor's right halo
        out = all_reduce(torch.cat([sums.to(torch.float64), halo.flatten(1).to(torch.float64)], dim=1), ax)
        mine_halo = out[:, sums.shape[1]:].reshape(p, ax.size, 2, PAD)[:, ax.index].long()
        ext = torch.cat([mine_halo[:, 0], a_loc, mine_halo[:, 1]], dim=1)
        g = start - PAD + torch.arange(local + 2 * PAD, device=a_loc.device)
        return out[:, : sums.shape[1]], torch.where((g >= 0) & (g < d_pad), ext, -1)

    def owned(d, a_loc):
        """Whether this rank holds day d [P, W], and d's slot in the slice (clamped)."""
        return (d >= start) & (d < start + local), (d - start).clamp(0, local - 1)

    def neighborhood(a_loc, cur_score, draws, active):
        t = tab(a_loc.device)
        p = a_loc.shape[0]
        is_swap, d1, d2, new_emp = sample_random_moves(draws, w_size, d_days, n_emp, active)
        own1, loc1 = owned(d1, a_loc)
        own2, loc2 = owned(d2, a_loc)
        olds = torch.cat([
            torch.where(own1, a_loc.gather(1, loc1), 0), torch.where(own2, a_loc.gather(1, loc2), 0),
        ], dim=1)
        sums, ext = exchange(a_loc, torch.cat([aggregates(a_loc, t, start, n_emp).double(), olds.double()], 1))
        wd_counts, tot, wk = finish_aggregates(sums[:, : 7 * n_emp].float(), n_emp)
        e1, e2 = sums[:, 7 * n_emp :].long().split(w_size, dim=1)
        n1 = torch.where(is_swap, e2, new_emp)
        n2 = torch.where(is_swap, e1, e2)

        reg = torch.arange(REG, device=a_loc.device)

        def region(own, loc, dj, d_excl, use_excl):
            at = loc[..., None] + reg  # [P, W, REG] into ext
            sl = ext.gather(1, at.reshape(p, -1)).view(*at.shape)
            dh, ds = region_deltas(sl, t.wk_pad[start + at], d1, n1, d2, n2, e1, e2, dj, d_excl, use_excl, d_days)
            return torch.where(own, dh, 0.0), torch.where(own, ds, 0.0)

        dh_a, ds_a = region(own1, loc1, d1, d2, False)
        dh_b, ds_b = region(own2, loc2, d2, d1, True)
        win = all_reduce(torch.stack([dh_a + dh_b, ds_a + ds_b]), ax)

        def hol(d, e):
            return t.holiday.view(-1)[d * n_emp + e]

        d_h1 = (hol(d1, n1) - hol(d1, e1)) + (hol(d2, n2) - hol(d2, e2))
        oh1 = _one_hot(n1, n_emp) - _one_hot(e1, n_emp)
        oh2 = _one_hot(n2, n_emp) - _one_hot(e2, n_emp)
        upd = (
            wd_counts[:, None]
            + _one_hot(t.weekday[d1], 5)[..., :, None] * oh1[..., None, :]
            + _one_hot(t.weekday[d2], 5)[..., :, None] * oh2[..., None, :]
        )
        d_s2 = s2_of(upd) - s2_of(wd_counts)[:, None]
        wkf = t.weekend.to(torch.float32)
        tot_new = tot[:, None] + oh1 + oh2
        wk_new = wk[:, None] + wkf[d1][..., None] * oh1 + wkf[d2][..., None] * oh2
        d_s34 = s34_of(tot_new, wk_new) - s34_of(tot, wk)[:, None]
        d_hard = d_h1 + win[0]
        d_soft = win[1] + d_s2 + d_s34
        return Neighborhood(
            scores=cur_score[:, None, :] + torch.stack([d_hard, d_soft], dim=-1),
            moves=SeqMoves(is_swap, d1, d2, new_emp, e1, e2),
            valid=torch.ones_like(d_hard, dtype=torch.bool),
            fp_deltas=torch.stack(_swap_fp_delta_planes(d1, e1, n1, d2, e2, n2), dim=-1),
        )

    def resolve(moves: SeqMoves, idx):
        flat = idx.reshape(idx.shape[0], -1)
        is_swap, d1, d2, new_emp, e1, e2 = (m.gather(1, flat).view(idx.shape) for m in moves)
        return d1, e1, torch.where(is_swap, e2, new_emp), d2, e2, torch.where(is_swap, e1, e2)

    def move_fp(a_loc, cur_fp, moves, idx):
        d1, e1, n1, d2, e2, n2 = resolve(moves, idx)
        fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
        return fp_update(fp_update(fp, d1, e1, n1), d2, e2, n2)

    def apply_move(a_loc, moves, idx):
        d1, _e1, n1, d2, _e2, n2 = resolve(moves, idx)
        g = start + torch.arange(local, device=a_loc.device)
        return torch.where(g == d1[:, None], n1[:, None], torch.where(g == d2[:, None], n2[:, None], a_loc))

    def perturb(a_loc, is_elite, draws):
        return mine(perturb_dense(whole(a_loc), is_elite, draws))

    return Problem(
        name=f"seq-scheduling-{d_days}d-{n_emp}e-x{ax.size}",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=neighborhood,
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=w_size,
    )


class SeqShardedSolver(PopulationSolver):
    """A population of date-sharded trajectories over a (pop, seq) mesh (or a
    seq-only one, ``make_mesh(1, S, ("pop", "seq"))``): lanes over ``pop``,
    days over ``seq``.  With ``population=1`` it is the single-trajectory
    date-sharded solver, on the draws of a one-lane ``Solver``.  The
    ``PopulationSolver`` driver API is kept; ``get_best_solution`` returns the
    whole schedule [D], and a checkpoint holds the whole schedules [P, D]."""

    def __init__(
        self,
        spec: ScheduleSpec,
        config: SolverConfig,
        mesh: Mesh,
        axis: str = "seq",
        window_size: int = 100,
        population: int = 1,
        exchange_every: int = 10,
        k_exchange: int = 4,
        portfolio: str = "reference",
        cull_frac: float = 0.0,
        cull_rank: str = "lex",
        device="cuda",
        draws=None,
    ):
        self.spec = spec
        self.axis = axis
        self._local = local_days(spec, mesh.axis(axis).size)
        problem = make_seq_scheduling_problem(spec, mesh, axis, window_size)
        super().__init__(
            problem, config, population, exchange_every=exchange_every,
            k_exchange=k_exchange if population > 1 else 0, portfolio=portfolio, cull_frac=cull_frac,
            cull_rank=cull_rank, device=device, draws=draws, mesh=mesh,
        )
        # The padding days hold -1 in every slot, the empty archive slots too,
        # so a checkpoint's whole schedules round-trip exactly.
        pad = self._pad_days()
        elite = self.state.elite
        self.state = self.state._replace(
            elite=elite._replace(states=torch.where(pad, -1, elite.states))
        )

    def _pad_days(self) -> torch.Tensor:
        start = self.mesh.axis(self.axis).index * self._local
        return start + torch.arange(self._local, device=self.device) >= self.spec.num_days

    def _days(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's days of x [..., local] → [..., D]."""
        return all_gather(x, self.mesh.axis(self.axis), dim=x.dim() - 1)[..., : self.spec.num_days]

    def _full_state(self, state):
        return self._days(state)

    def _dense_state(self, state):
        state = super()._dense_state(state)
        return state._replace(
            current_state=self._days(state.current_state),
            elite=state.elite._replace(states=self._days(state.elite.states)),
        )

    def _shard_state(self, state):
        state = super()._shard_state(state)
        ax = self.mesh.axis(self.axis)
        local = self._local

        def mine(x):
            pad = x.new_full((*x.shape[:-1], local * ax.size - x.shape[-1]), -1)
            return torch.cat([x, pad], dim=-1)[..., ax.index * local : (ax.index + 1) * local]

        return state._replace(
            current_state=mine(state.current_state),
            elite=state.elite._replace(states=mine(state.elite.states)),
        )
