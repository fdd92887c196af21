"""Employee scheduling: 4 hard + 4 soft constraints, delta-evaluated
(port of ``constraint_solver_tpu/models/scheduling.py``).

Same semantics as the JAX package: one employee per day (``assign[day] =
employee``), score (hard, soft) with

- H1 an employee works their own holiday, H2 the same employee on two
  consecutive days, H3 consecutive weekends (9-day windows starting on a weekend
  pair, positions {0, 1} × {7, 8}), H4 more than 3 shifts in a 14-day window;
- S1 more than 2 shifts in a 7-day window, S2 weekday consistency (Mon–Fri), S3
  and S4 the max–min spreads of total and weekend days over employees with at
  least one day;

and four proposers:

- ``"random"``: a window of W random ChangeDay / SwapDays moves (1 : 4), each
  scored exactly by the 27-day region deltas (``exact_move_deltas``);
- ``"rescore"``: the same moves, each candidate fully rescored (bit-identical
  to ``"random"``);
- ``"dense"``: every ChangeDay move as one [D, E] block, ``n_rand_swaps``
  unrestricted random swaps scored as ``exact_move_deltas`` scores them, and
  ``n_swap_offsets`` window-disjoint swap diagonals (days d and d + δ, δ ≥ 14),
  in that order (the flat index decides first-index ties): one call of K5
  (``ops/sched_dense.py``), whose kernels write each block in its place on
  the card and whose plain version, the eager chain, runs on the CPU;
- ``"systematic"``: the reference's unused proposer, every day rotated through
  its E − 1 successor employees, D·(E − 1) full candidate states [P, D(E−1), D],
  each scored by ``score``; a move is its candidate state (``move_fp`` is the
  candidate's fingerprint, ``apply_move`` takes the candidate).

Every function takes lane-batched tensors: an assignment is int64[P, D], a
move batch is ``SchedMoves`` of [P, W] tensors.

Divergences from the JAX package:

- **Assignments are int64**, PyTorch's index type (int32 there), like boards.
- **Gathers instead of one-hot contractions.** The TPU code writes per-move day
  lookups, the 27-day region slices and the weekday rows as one-hot × table
  contractions and shift-matrix einsums.  Here they are gathers of the padded
  tables.
- **Window counts are banded 0/1 matmuls** (``_window_band``), in the region
  deltas too, where the JAX package slides a cumulative sum; the dense block's
  are the JAX package's own.  Both factors are 0/1, exact in TF32 as in
  float32, so every product is 0 or 1 and every sum counts at most 14 ones in
  a float32 accumulator: any order of summation, on any device, gives the
  same integers bit for bit.
- **One-hots are comparisons with ``arange``**: an out-of-range index (the −1
  and −2 padding, weekdays 5 and 6) gives a zero row, as ``jax.nn.one_hot``
  does.
- **Draws** come from a ``Draws`` source (``random_moves``, ``dense_swaps``,
  ``assignment``, ``perturb``).
- **The systematic proposer draws nothing** and calls ``draws.advance``, as
  the other draw-free proposers do.

The module-level tensor helpers (``region_deltas``, ``move_region_deltas``,
``s2_of``, ``s34_of``, ``spread_of``, ``_one_hot``, ``exact_move_deltas``,
``make_tables``) serve the date-sharded solver (``parallel/seq_solver.py``,
``parallel/seq_shard.py``) and K5's plain version too.

Every proposer is ``capturable`` (``core/problem.py``): on the card the solvers
replay its descent iterations as CUDA graphs.  The per-device tables are filled
by the first ``score`` on a device, before any capture.
"""

from __future__ import annotations

import dataclasses
import datetime
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem, replayable
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, hash_xor
from constraint_solver_tpu_torch.ops.lex import make_score
from constraint_solver_tpu_torch.ops.sched_dense import sched_dense

# Delta-evaluation region: the widest window is 14 days (H4), so windows
# containing day d start in [d-13, d] and span days [d-13, d+13].
PAD = 13
REG = 2 * PAD + 1  # 27
_BIG = 1e9


class SchedMoves(NamedTuple):
    """A batch of moves, each [P, W]: ChangeDay sets day ``d1`` to ``new_emp``;
    SwapDays (``is_swap``) exchanges the employees of days ``d1`` and ``d2``."""

    is_swap: torch.Tensor  # bool
    d1: torch.Tensor       # int64
    d2: torch.Tensor       # int64
    new_emp: torch.Tensor  # int64


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of x[...] over n classes; out-of-range values give a zero row."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(torch.float32)


def _shf(x: torch.Tensor, k: int, fill, dim: int) -> torch.Tensor:
    """y[d] = x[d + k] along ``dim`` (static k of either sign), ``fill`` out of range."""
    size = x.shape[dim]
    if k == 0:
        return x
    if abs(k) >= size:
        return torch.full_like(x, fill)
    pad_shape = list(x.shape)
    pad_shape[dim] = abs(k)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if k > 0:
        return torch.cat([x.narrow(dim, k, size - k), pad], dim=dim)
    return torch.cat([pad, x.narrow(dim, 0, size + k)], dim=dim)


def _window_band(n_days: int, width: int, device) -> torch.Tensor:
    """float32[max(n_days - width + 1, 0), n_days]: 1 where window start s
    contains day d (s <= d < s + width).  A product with it counts windows,
    its transpose sums over the windows containing each day."""
    return torch.ones(max(n_days - width + 1, 0), n_days, device=device).triu().tril(width - 1)


def region_deltas(sl_old, wk_sl, d1, n1, d2, n2, e1, e2, dj, d_excl, use_excl: bool, d_days: int):
    """(hard_delta, s1_delta) [...] over the windows containing day ``dj``.

    ``sl_old`` / ``wk_sl`` [..., REG] are the 27-day assignment and weekend
    slices covering days [dj-13, dj+13] (employee -1 / weekend False out of
    range); the other arguments are [...].  Both point changes that fall in the
    region are applied, and the per-window value differences are summed over
    the starts w in [dj-K+1, dj] for K = 2 (H2), 9 (H3), 14 (H4), 7 (S1).  With
    ``use_excl``, starts in [d_excl-K+1, d_excl] are left out (already counted
    for that day).  H4/S1 counts are tracked only for the <= 4 employees the
    move touches, each counted once.  Module-level, as in the JAX package, for
    the date-sharded solver."""
    f32 = torch.float32
    iota = torch.arange(REG, device=sl_old.device)
    sl_new = torch.where(iota == (d1 - dj + PAD)[..., None], n1[..., None], sl_old)
    sl_new = torch.where(iota == (d2 - dj + PAD)[..., None], n2[..., None], sl_new)

    w_all = (dj - PAD)[..., None] + iota  # window starts

    def fam_mask(k):
        m = (w_all >= (dj - k + 1)[..., None]) & (w_all <= dj[..., None])
        m &= (w_all >= 0) & (w_all <= d_days - k)
        if use_excl:
            m &= ~((w_all >= (d_excl - k + 1)[..., None]) & (w_all <= d_excl[..., None]))
        return m.to(f32)

    def h2_vals(sl):
        return (sl == _shf(sl, 1, -2, -1)).to(f32)

    def h3_vals(sl):
        a0, a1 = sl, _shf(sl, 1, -2, -1)
        a7, a8 = _shf(sl, 7, -3, -1), _shf(sl, 8, -4, -1)
        cond = wk_sl & _shf(wk_sl, 1, False, -1)
        eqs = (a0 == a7).to(f32) + (a0 == a8) + (a1 == a7) + (a1 == a8)
        return torch.where(cond, eqs, 0.0)

    d_h2 = (fam_mask(2) * (h2_vals(sl_new) - h2_vals(sl_old))).sum(-1)
    d_h3 = (fam_mask(9) * (h3_vals(sl_new) - h3_vals(sl_old))).sum(-1)

    # H4/S1: sliding counts of the 4 move employees, first occurrences only.
    emps = torch.stack([e1, n1, e2, n2], dim=-1)  # [..., 4]
    first = torch.stack(
        [
            torch.ones_like(n1, dtype=torch.bool),
            n1 != e1,
            (e2 != e1) & (e2 != n1),
            (n2 != e1) & (n2 != n1) & (n2 != e2),
        ],
        dim=-1,
    ).to(f32)
    sl_both = torch.stack([sl_old, sl_new], dim=-2)  # [..., 2, REG]
    ind = (sl_both[..., None, :] == emps[..., None, :, None]).to(f32)  # [..., 2, 4, REG]

    def d_fam(k, thresh):
        n_win = REG + 1 - k
        over = (ind @ _window_band(REG, k, ind.device).T > thresh).to(f32)  # [..., 2, 4, n_win]
        per_emp = over[..., 1, :, :] - over[..., 0, :, :]
        return (fam_mask(k)[..., None, :n_win] * first[..., :, None] * per_emp).sum((-1, -2))

    return d_h2 + d_h3 + d_fam(14, 3), d_fam(7, 2)


def move_region_deltas(a_pad, wk_pad, d1, n1, d2, n2, e1, e2, d_days: int):
    """``region_deltas`` of both regions of W two-point moves per lane, in one
    pass: (hard_delta, s1_delta) [P, 2, W], d1's region at [:, 0] (nothing
    excluded), d2's at [:, 1] (the starts already counted for d1 left out).
    ``a_pad`` [P, D + 2*PAD] is the assignment with employee -1 on PAD days at
    either end, ``wk_pad`` [D + 2*PAD] its weekend flags; the moves are [P, W].
    d1's region takes a ``d_excl`` so far below day 0 that it leaves out only
    negative starts, which the region mask drops anyway."""
    p, w = d1.shape
    dj = torch.cat([d1, d2], dim=1)  # [P, 2W]
    at = dj[..., None] + torch.arange(REG, device=a_pad.device)  # [P, 2W, REG] into the padded tables
    sl = a_pad.gather(1, at.reshape(p, -1)).view(p, 2, w, REG)
    d_excl = torch.cat([torch.full_like(d1, -2 * REG), d1], dim=1)
    return region_deltas(
        sl, wk_pad[at].view(p, 2, w, REG), *(x[:, None] for x in (d1, n1, d2, n2, e1, e2)),
        dj.view(p, 2, w), d_excl.view(p, 2, w), True, d_days,
    )


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Static problem data: day count, employee count, the weekday of the first
    day, and a dense employee × day holiday mask (numpy only, hashable)."""

    num_days: int
    num_employees: int
    start_weekday: int  # 0 = Monday
    holiday_mask: tuple = ()  # hashable; holiday_array() gives the ndarray

    @staticmethod
    def from_dates(
        start_date: datetime.date,
        end_date: datetime.date,
        num_employees: int,
        employee_holidays: dict[int, list[datetime.date]] | None = None,
    ) -> "ScheduleSpec":
        num_days = (end_date - start_date).days + 1
        mask = np.zeros((num_employees, num_days), bool)
        for emp, days in (employee_holidays or {}).items():
            for day in days:
                idx = (day - start_date).days
                if 0 <= idx < num_days:
                    mask[emp, idx] = True
        return ScheduleSpec(
            num_days=num_days,
            num_employees=num_employees,
            start_weekday=start_date.weekday(),
            holiday_mask=tuple(map(tuple, mask.tolist())),
        )

    def holiday_array(self) -> np.ndarray:
        if not self.holiday_mask:
            return np.zeros((self.num_employees, self.num_days), bool)
        return np.asarray(self.holiday_mask, bool)

    def weekdays(self) -> np.ndarray:
        return (self.start_weekday + np.arange(self.num_days)) % 7

    def is_weekend(self) -> np.ndarray:
        return self.weekdays() >= 5  # Sat=5, Sun=6


def sample_random_moves(draws, w_size: int, d_days: int, n_emp: int, active) -> SchedMoves:
    """W random moves per lane ~ {ChangeDay: 1, SwapDays: 4}; the swap's day
    pair is uniform over distinct pairs via d1 + U[1, D) mod D.  Module-level,
    as in the JAX package, for the date-sharded solver."""
    dr = draws.random_moves(w_size, d_days, n_emp, active)
    return SchedMoves(dr.u_type < 0.8, dr.d1, (dr.d1 + dr.off) % d_days, dr.new_emp)


def _swap_fp_delta_planes(d1, e1, n1, d2, e2, n2):
    """XOR fingerprint delta of a two-point move as two int64 planes of uint32
    values (ChangeDay has n2 == e2, whose hash terms cancel), in one K2a launch."""
    return tuple(hash_xor(None, ((d1, e1), (d1, n1), (d2, e2), (d2, n2)), planes=True))


def s2_of(wd_counts: torch.Tensor) -> torch.Tensor:
    """S2 from [..., 5, E] weekday × employee counts: per weekday with more than
    one employee, the least count among those present."""
    present = wd_counts > 0
    n_present = present.sum(-1)
    min_present = torch.where(present, wd_counts, torch.inf).amin(-1)
    return torch.where(n_present > 1, min_present, 0.0).sum(-1)


def spread_of(v: torch.Tensor, present: torch.Tensor, n_pres: torch.Tensor) -> torch.Tensor:
    """Max–min spread of ``v`` [..., E] over ``present`` (broadcast), 0 unless
    ``n_pres`` >= 2."""
    mx = torch.where(present, v, -torch.inf).amax(-1)
    mn = torch.where(present, v, torch.inf).amin(-1)
    return torch.where(n_pres >= 2, mx - mn, 0.0)


def s34_of(tot: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """S3 + S4 from totals and weekend totals [..., E]; "present" is >= 1 total
    day for both spreads."""
    present = tot > 0
    n_pres = present.sum(-1)
    return spread_of(tot, present, n_pres) + spread_of(wk, present, n_pres)


class _Tables(NamedTuple):
    holiday_de: torch.Tensor    # float32[D, E]
    weekend: torch.Tensor       # bool[D]
    weekend_f: torch.Tensor     # float32[D]
    weekday: torch.Tensor       # int64[D]
    wk_pad: torch.Tensor        # bool[D + 2*PAD]
    band7: torch.Tensor         # float32[max(D - 6, 0), D]: window s of 7 days contains day d
    band14: torch.Tensor        # float32[max(D - 13, 0), D]: the same for 14 days


def make_tables(spec: ScheduleSpec, device) -> _Tables:
    """The tables of ``spec`` on ``device``: what ``score`` and the proposers read."""
    d_days = spec.num_days
    weekend = torch.as_tensor(spec.is_weekend())
    t = _Tables(
        holiday_de=torch.as_tensor(spec.holiday_array().T, dtype=torch.float32).contiguous(),
        weekend=weekend,
        weekend_f=weekend.to(torch.float32),
        weekday=torch.as_tensor(spec.weekdays(), dtype=torch.int64),
        wk_pad=torch.cat([torch.zeros(PAD, dtype=torch.bool), weekend, torch.zeros(PAD, dtype=torch.bool)]),
        band7=_window_band(d_days, 7, "cpu"),
        band14=_window_band(d_days, 14, "cpu"),
    )
    return t._replace(**{f: getattr(t, f).to(device) for f in t._fields})


def _wd_counts(t: _Tables, oh: torch.Tensor) -> torch.Tensor:
    """[P, 5, E] weekday × employee counts of one-hot assignments [P, D, E]."""
    out = oh.new_zeros((oh.shape[0], 7, oh.shape[-1]))
    return out.index_add_(1, t.weekday, oh)[:, :5]


def _totals(t: _Tables, oh: torch.Tensor):
    """Totals and weekend totals [P, E] of one-hot assignments [P, D, E]."""
    return oh.sum(1), (oh * t.weekend_f[:, None]).sum(1)


def exact_move_deltas(t: _Tables, assign, moves: SchedMoves, n_emp: int, d_days: int):
    """Exact (d_hard [P, W], d_soft [P, W], fp delta planes) of W arbitrary
    ChangeDay/SwapDays moves per lane, any day pair, through the 27-day
    region deltas; ``t`` the problem's tables on the assignment's device."""
    p = assign.shape[0]
    oh = _one_hot(assign, n_emp)
    wd_counts = _wd_counts(t, oh)     # [P, 5, E]
    tot, wk = _totals(t, oh)          # [P, E]
    s2_base = s2_of(wd_counts)
    s34_base = s34_of(tot, wk)
    edge = assign.new_full((p, PAD), -1)
    a_pad = torch.cat([edge, assign, edge], dim=1)

    is_swap, d1, d2, new_emp = moves
    e1, e2 = assign.gather(1, d1), assign.gather(1, d2)
    n1 = torch.where(is_swap, e2, new_emp)
    n2 = torch.where(is_swap, e1, e2)  # identity for ChangeDay

    dh, ds1 = move_region_deltas(a_pad, t.wk_pad, d1, n1, d2, n2, e1, e2, d_days)  # [P, 2, W]

    def hol(d, e):
        return t.holiday_de.view(-1)[d * n_emp + e]

    d_h1 = (hol(d1, n1) - hol(d1, e1)) + (hol(d2, n2) - hol(d2, e2))

    oh1 = _one_hot(n1, n_emp) - _one_hot(e1, n_emp)  # [P, W, E]
    oh2 = _one_hot(n2, n_emp) - _one_hot(e2, n_emp)
    upd = (
        wd_counts[:, None]
        + _one_hot(t.weekday[d1], 5)[..., :, None] * oh1[..., None, :]
        + _one_hot(t.weekday[d2], 5)[..., :, None] * oh2[..., None, :]
    )  # [P, W, 5, E]
    d_s2 = s2_of(upd) - s2_base[:, None]
    tot_new = tot[:, None] + oh1 + oh2
    wk_new = wk[:, None] + t.weekend_f[d1][..., None] * oh1 + t.weekend_f[d2][..., None] * oh2
    d_s34 = s34_of(tot_new, wk_new) - s34_base[:, None]

    fpd = _swap_fp_delta_planes(d1, e1, n1, d2, e2, n2)
    return d_h1 + dh[:, 0] + dh[:, 1], ds1[:, 0] + ds1[:, 1] + d_s2 + d_s34, fpd


@lru_cache(maxsize=32)
def make_scheduling_problem(
    spec: ScheduleSpec,
    window_size: int = 100,
    proposer: str = "dense",
    n_swap_offsets: int = 4,
    n_rand_swaps: int = 64,
) -> Problem:
    """The scheduling problem of ``spec`` with the given proposer (see the module
    docstring).  Cached on its arguments; the per-device tables are built at
    first use on each device."""
    if proposer not in ("dense", "random", "rescore", "systematic"):
        raise ValueError(f"unknown proposer {proposer!r}")
    d_days, n_emp, w_size = spec.num_days, spec.num_employees, window_size
    f32 = torch.float32
    n_off = n_swap_offsets if d_days >= 15 else 0
    n_rand = n_rand_swaps if d_days >= 2 else 0
    tables: dict[torch.device, _Tables] = {}

    def tab(device: torch.device) -> _Tables:
        if device not in tables:
            tables[device] = make_tables(spec, device)
        return tables[device]

    def score(assign: torch.Tensor) -> torch.Tensor:
        t = tab(assign.device)
        a = assign
        oh = _one_hot(a, n_emp)  # [P, D, E]
        h1 = (oh * t.holiday_de).sum((1, 2))
        h2 = (a[:, :-1] == a[:, 1:]).sum(-1) if d_days >= 2 else 0
        h3 = 0.0
        if d_days >= 9:
            cond = t.weekend[: d_days - 8] & t.weekend[1 : d_days - 7]
            e17 = a[:, : d_days - 8] == a[:, 7 : d_days - 1]
            e18 = a[:, : d_days - 8] == a[:, 8:d_days]
            e27 = a[:, 1 : d_days - 7] == a[:, 7 : d_days - 1]
            e28 = a[:, 1 : d_days - 7] == a[:, 8:d_days]
            h3 = torch.where(cond, e17.to(f32) + e18 + e27 + e28, 0.0).sum(-1)
        csum = torch.cat([oh.new_zeros((a.shape[0], 1, n_emp)), oh.cumsum(1)], dim=1)
        h4 = (csum[:, 14:] - csum[:, :-14] > 3).sum((1, 2)) if d_days >= 14 else 0
        s1 = (csum[:, 7:] - csum[:, :-7] > 2).sum((1, 2)) if d_days >= 7 else 0
        s2 = s2_of(_wd_counts(t, oh))
        s34 = s34_of(*_totals(t, oh))
        return make_score((h1 + h2 + h3 + h4).to(f32), (s1 + s2 + s34).to(f32))

    def init(draws):
        return draws.assignment(d_days, n_emp)

    def is_best(s):
        return (s[..., 0] == 0) & (s[..., 1] == 0)

    def resolve_move(assign, moves: SchedMoves, idx):
        """Each lane's moves at ``idx`` [P, ...] as two (day, old -> new) point
        changes; ChangeDay's second change is the identity (n2 == e2)."""
        flat = idx.reshape(idx.shape[0], -1)
        is_swap, d1, d2, new_emp = (m.gather(1, flat) for m in moves)
        e1, e2 = assign.gather(1, d1), assign.gather(1, d2)
        n1 = torch.where(is_swap, e2, new_emp)
        n2 = torch.where(is_swap, e1, e2)
        return tuple(x.view(idx.shape) for x in (d1, e1, n1, d2, e2, n2))

    def neighborhood(assign, cur_score, draws, active):
        moves = sample_random_moves(draws, w_size, d_days, n_emp, active)
        d_hard, d_soft, fpd = exact_move_deltas(tab(assign.device), assign, moves, n_emp, d_days)
        return Neighborhood(
            scores=cur_score[:, None, :] + torch.stack([d_hard, d_soft], dim=-1),
            moves=moves,
            valid=torch.ones_like(d_hard, dtype=torch.bool),
            fp_deltas=torch.stack(fpd, dim=-1),
        )

    def materialize(assign, moves: SchedMoves):
        """Candidate assignments [P, W, D], one row per move."""
        is_swap, d1, d2, new_emp = moves
        iota = torch.arange(d_days, device=assign.device)
        at_d1 = iota == d1[..., None]
        at_d2 = iota == d2[..., None]
        base = assign[:, None, :]
        a1 = assign.gather(1, d1)[..., None]
        a2 = assign.gather(1, d2)[..., None]
        chg = torch.where(at_d1, new_emp[..., None], base)
        swp = torch.where(at_d1, a2, torch.where(at_d2, a1, base))
        return torch.where(is_swap[..., None], swp, chg)

    def neighborhood_rescore(assign, _cur_score, draws, active):
        """The same moves as ``neighborhood``, each candidate fully rescored."""
        moves = sample_random_moves(draws, w_size, d_days, n_emp, active)
        cands = materialize(assign, moves)
        p, w = cands.shape[:2]
        scores = score(cands.reshape(p * w, d_days)).view(p, w, 2)
        fpd = fingerprint_i32(assign)[:, None, :] ^ fingerprint_i32(cands)
        return Neighborhood(
            scores=scores, moves=moves, valid=torch.ones((p, w), dtype=torch.bool, device=assign.device),
            fp_deltas=fpd,
        )

    def neighborhood_dense(assign, cur_score, draws, active):
        """Every D × E ChangeDay delta as one dense block, ``n_rand`` random
        swaps and ``n_off`` swap diagonals; every delta is exact.  One call of
        K5 (``ops/sched_dense.py``), which writes each block in its place."""
        dr = draws.dense_swaps(n_rand, n_off, d_days, active)
        t = tab(assign.device)
        out = sched_dense(assign, cur_score, t, spec.start_weekday, dr.rs_d1, dr.rs_off, dr.delta)
        return Neighborhood(
            scores=out.scores, moves=SchedMoves(out.is_swap, out.d1, out.d2, out.new_emp), valid=out.valid,
            fp_deltas=out.fp_deltas,
        )

    def move_fp(assign, cur_fp, moves, idx):
        d1, e1, n1, d2, e2, n2 = resolve_move(assign, moves, idx)
        fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
        return hash_xor(fp, ((d1, e1), (d1, n1), (d2, e2), (d2, n2)))

    def apply_move(assign, moves, idx):
        d1, _e1, n1, d2, _e2, n2 = resolve_move(assign, moves, idx)
        iota = torch.arange(d_days, device=assign.device)
        return torch.where(iota == d1[:, None], n1[:, None], torch.where(iota == d2[:, None], n2[:, None], assign))

    def neighborhood_systematic(assign, _cur_score, draws, active):
        """Every day rotated through its E − 1 successor employees: D·(E − 1)
        candidate assignments per lane, each fully scored."""
        draws.advance(active)
        p = assign.shape[0]
        iota_d = torch.arange(d_days, device=assign.device)
        new_vals = (assign[:, :, None] + torch.arange(1, n_emp, device=assign.device)) % n_emp  # [P, D, E-1]
        cands = torch.where(
            iota_d[:, None, None] == iota_d, new_vals[..., None], assign[:, None, None, :]
        ).reshape(p, -1, d_days)  # [P, D(E-1), D]
        w = cands.shape[1]
        return Neighborhood(
            scores=score(cands.reshape(p * w, d_days)).view(p, w, 2),
            moves=cands,
            valid=torch.ones((p, w), dtype=torch.bool, device=assign.device),
        )

    def take_states(moves, idx):
        """The candidate states at ``idx`` [P, ...]: [P, ..., D]."""
        flat = idx.reshape(idx.shape[0], -1)
        return moves.gather(1, flat[..., None].expand(-1, -1, d_days)).view(*idx.shape, d_days)

    def move_fp_states(_assign, _cur_fp, moves, idx):
        return fingerprint_i32(take_states(moves, idx))

    def apply_move_states(_assign, moves, idx):
        return take_states(moves, idx)

    fp_fn, apply_fn = move_fp, apply_move
    if proposer == "systematic":
        nbr_fn, width = neighborhood_systematic, d_days * (n_emp - 1)
        fp_fn, apply_fn = move_fp_states, apply_move_states
    elif proposer == "dense":
        nbr_fn, width = neighborhood_dense, d_days * n_emp + n_off * d_days + n_rand
    else:
        nbr_fn = neighborhood if proposer == "random" else neighborhood_rescore
        width = w_size

    return Problem(
        name=f"scheduling-{d_days}d-{n_emp}e",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint_i32,
        neighborhood=replayable(nbr_fn),
        move_fp=fp_fn,
        apply_move=apply_fn,
        perturb=_make_perturb(d_days, n_emp),
        width=width,
        capturable=True,
    )


def _make_perturb(d_days: int, n_emp: int):
    def perturb(assign, is_elite, draws):
        # {ChangeDaysSubsetRandomly: 100, DoNothing: 10}; k ~ U[1, D/20] near
        # elites, else U[1, D/2]; the k days with the smallest draws change.
        hi = torch.where(is_elite, max(1, d_days // 20), max(1, d_days // 2))
        dr = draws.perturb(d_days, hi, n_emp)
        do_change = dr.u_strat < (100.0 / 110.0)
        kth = torch.sort(dr.u, dim=-1).values.gather(1, (dr.n_alter - 1)[:, None])
        alter = do_change[:, None] & (dr.u <= kth)
        return torch.where(alter, dr.new_rows, assign)

    return perturb
