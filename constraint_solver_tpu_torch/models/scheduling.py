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
  unrestricted random swaps through ``exact_move_deltas``, and
  ``n_swap_offsets`` window-disjoint swap diagonals (days d and d + δ, δ ≥ 14),
  concatenated in that order (the flat index decides first-index ties);
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
  contractions and shift-matrix einsums, and the window counts of the dense
  block as banded matmuls.  Here they are gathers of the padded tables and
  cumulative sums.  Every value is a small integer in float32, so the results
  are the same integers, bit for bit, and no matmul (so no TF32) is involved.
- **One-hots are comparisons with ``arange``**: an out-of-range index (the −1
  and −2 padding, weekdays 5 and 6) gives a zero row, as ``jax.nn.one_hot``
  does.
- **Draws** come from a ``Draws`` source (``random_moves``, ``dense_swaps``,
  ``assignment``, ``perturb``).
- **The systematic proposer draws nothing** and calls ``draws.advance``, as
  the other draw-free proposers do.
"""

from __future__ import annotations

import dataclasses
import datetime
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, fp_update, position_hash_planes
from constraint_solver_tpu_torch.ops.lex import make_score

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

    def csum4(sl):
        ind = (sl[..., None, :] == emps[..., :, None]).to(f32)  # [..., 4, REG]
        zero = torch.zeros(ind.shape[:-1] + (1,), dtype=f32, device=ind.device)
        return torch.cat([zero, ind.cumsum(-1)], dim=-1)

    cs_old, cs_new = csum4(sl_old), csum4(sl_new)

    def d_fam(k, thresh):
        def over(cs):
            v = ((cs[..., k:] - cs[..., :-k]) > thresh).to(f32)  # [..., 4, REG+1-k]
            return torch.nn.functional.pad(v, (0, k - 1))

        per_emp = over(cs_new) - over(cs_old)
        return (fam_mask(k)[..., None, :] * first[..., :, None] * per_emp).sum((-1, -2))

    return d_h2 + d_h3 + d_fam(14, 3), d_fam(7, 2)


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
    values (ChangeDay has n2 == e2, whose hash terms cancel)."""
    a0, a1 = position_hash_planes(d1, e1)
    b0, b1 = position_hash_planes(d1, n1)
    c0, c1 = position_hash_planes(d2, e2)
    f0, f1 = position_hash_planes(d2, n2)
    return a0 ^ b0 ^ c0 ^ f0, a1 ^ b1 ^ c1 ^ f1


def _cat_blocks(blocks) -> Neighborhood:
    """Concatenate (hard, soft, moves, valid, fp0, fp1) blocks, each [P, w], in order."""
    cat = lambda *xs: torch.cat(xs, dim=1)  # noqa: E731
    parts = list(zip(*blocks))
    return Neighborhood(
        scores=torch.stack([cat(*parts[0]), cat(*parts[1])], dim=-1),
        moves=SchedMoves(*(cat(*m) for m in zip(*parts[2]))),
        valid=cat(*parts[3]),
        fp_deltas=torch.stack([cat(*parts[4]), cat(*parts[5])], dim=-1),
    )


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
    h_de0: torch.Tensor         # int64[D, E] position hash h(d, e), fingerprint lane 0
    h_de1: torch.Tensor         # int64[D, E] lane 1
    windows: dict               # width -> (hi, lo) int64[D]: window-start ranges per day


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
            weekend = torch.as_tensor(spec.is_weekend())
            holiday_de = torch.as_tensor(spec.holiday_array().T, dtype=f32).contiguous()
            iota_d = torch.arange(d_days)
            h0, h1 = position_hash_planes(iota_d[:, None], torch.arange(n_emp).expand(d_days, n_emp))
            windows = {}
            for width in (7, 14):
                n_win = d_days - width + 1
                windows[width] = (iota_d.clamp(max=n_win - 1) + 1, (iota_d - width + 1).clamp(min=0))
            t = _Tables(
                holiday_de=holiday_de,
                weekend=weekend,
                weekend_f=weekend.to(f32),
                weekday=torch.as_tensor(spec.weekdays(), dtype=torch.int64),
                wk_pad=torch.cat([torch.zeros(PAD, dtype=torch.bool), weekend, torch.zeros(PAD, dtype=torch.bool)]),
                h_de0=h0,
                h_de1=h1,
                windows=windows,
            )
            tables[device] = t._replace(
                **{f: getattr(t, f).to(device) for f in t._fields if f != "windows"},
                windows={k: (hi.to(device), lo.to(device)) for k, (hi, lo) in windows.items()},
            )
        return tables[device]

    def wd_counts_of(t: _Tables, oh: torch.Tensor) -> torch.Tensor:
        """[P, 5, E] weekday × employee counts of one-hot assignments [P, D, E]."""
        out = oh.new_zeros((oh.shape[0], 7, n_emp))
        return out.index_add_(1, t.weekday, oh)[:, :5]

    def totals(t: _Tables, oh: torch.Tensor):
        return oh.sum(1), (oh * t.weekend_f[:, None]).sum(1)

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
        s2 = s2_of(wd_counts_of(t, oh))
        s34 = s34_of(*totals(t, oh))
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

    def exact_move_deltas(assign, moves: SchedMoves):
        """Exact (d_hard [P, W], d_soft [P, W], fp delta planes) of W arbitrary
        ChangeDay/SwapDays moves per lane, any day pair, through the 27-day
        region deltas."""
        t = tab(assign.device)
        p = assign.shape[0]
        oh = _one_hot(assign, n_emp)
        wd_counts = wd_counts_of(t, oh)   # [P, 5, E]
        tot, wk = totals(t, oh)           # [P, E]
        s2_base = s2_of(wd_counts)
        s34_base = s34_of(tot, wk)
        edge = assign.new_full((p, PAD), -1)
        a_pad = torch.cat([edge, assign, edge], dim=1)

        is_swap, d1, d2, new_emp = moves
        w = d1.shape[1]
        e1, e2 = assign.gather(1, d1), assign.gather(1, d2)
        n1 = torch.where(is_swap, e2, new_emp)
        n2 = torch.where(is_swap, e1, e2)  # identity for ChangeDay
        reg = torch.arange(REG, device=assign.device)
        at1, at2 = d1[..., None] + reg, d2[..., None] + reg  # [P, W, REG] into the padded tables
        sl1 = a_pad.gather(1, at1.reshape(p, -1)).view(p, w, REG)
        sl2 = a_pad.gather(1, at2.reshape(p, -1)).view(p, w, REG)

        dh_a, ds1_a = region_deltas(sl1, t.wk_pad[at1], d1, n1, d2, n2, e1, e2, d1, d2, False, d_days)
        dh_b, ds1_b = region_deltas(sl2, t.wk_pad[at2], d1, n1, d2, n2, e1, e2, d2, d1, True, d_days)

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
        return d_h1 + dh_a + dh_b, ds1_a + ds1_b + d_s2 + d_s34, fpd

    def neighborhood(assign, cur_score, draws, active):
        moves = sample_random_moves(draws, w_size, d_days, n_emp, active)
        d_hard, d_soft, fpd = exact_move_deltas(assign, moves)
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

    def window_sum(t: _Tables, x: torch.Tensor, width: int) -> torch.Tensor:
        """out[:, d] = sum of x[:, s] over the window starts s whose window
        [s, s + width) contains day d; x is [P, D-width+1, E]."""
        hi, lo = t.windows[width]
        cx = torch.cat([x.new_zeros((x.shape[0], 1, n_emp)), x.cumsum(1)], dim=1)
        return cx[:, hi] - cx[:, lo]

    def neighborhood_dense(assign, cur_score, draws, active):
        """Every D × E ChangeDay delta as one dense block, ``n_rand`` random
        swaps and ``n_off`` swap diagonals; every delta is exact."""
        t = tab(assign.device)
        a = assign
        p = a.shape[0]
        dev = a.device
        oh = _one_hot(a, n_emp)  # [P, D, E]
        iota_d = torch.arange(d_days, device=dev)
        iota_e = torch.arange(n_emp, device=dev)

        # H1: holiday row minus the current day's holiday flag.
        h1_old = (t.holiday_de * oh).sum(-1)
        d_h1 = t.holiday_de - h1_old[..., None]

        # H2: the two adjacent pairs of each day.
        a_l, a_r = _shf(a, -1, -2, 1), _shf(a, 1, -3, 1)
        m_l = (iota_d >= 1).to(f32)
        m_r = (iota_d <= d_days - 2).to(f32)
        old2 = m_l * (a_l == a) + m_r * (a == a_r)
        new2 = m_l[:, None] * (a_l[..., None] == iota_e) + m_r[:, None] * (a_r[..., None] == iota_e)
        d_h2 = new2 - old2[..., None]

        # H3: the four windows where day d sits at position 0/1/7/8.
        cond = t.weekend & _shf(t.weekend, 1, False, 0)
        pairs = ((0, 7), (0, 8), (1, 7), (1, 8))

        def eq(i, j):
            return (_shf(a, i, -2, 1) == _shf(a, j, -3, 1)).to(f32)

        old3 = eq(0, 7) + eq(0, 8) + eq(1, 7) + eq(1, 8)
        d_h3 = oh.new_zeros((p, d_days, n_emp))
        for q in (0, 1, 7, 8):
            m_q = ((iota_d >= q) & (iota_d <= d_days - 9 + q)).to(f32) * _shf(cond, -q, False, 0)
            new_q = oh.new_zeros((p, d_days, n_emp))
            for i, j in pairs:
                if i == q:
                    new_q += (_shf(a, j - q, -2, 1)[..., None] == iota_e).to(f32)
                elif j == q:
                    new_q += (_shf(a, i - q, -2, 1)[..., None] == iota_e).to(f32)
                else:
                    new_q += (_shf(a, i - q, -2, 1) == _shf(a, j - q, -3, 1)).to(f32)[..., None]
            d_h3 += m_q[:, None] * (new_q - _shf(old3, -q, 0.0, 1)[..., None])

        # H4/S1: +1 on employee e flips a window iff its count is at the
        # threshold; -1 on the old employee iff one above.
        csum = torch.cat([oh.new_zeros((p, 1, n_emp)), oh.cumsum(1)], dim=1)

        def crossings(width, thresh):
            if d_days < width:
                z = oh.new_zeros((p, d_days, n_emp))
                return z, z
            cnt = csum[:, width:] - csum[:, :-width]  # [P, D-width+1, E]
            return (
                window_sum(t, (cnt == thresh).to(f32), width),
                window_sum(t, (cnt == thresh + 1).to(f32), width),
            )

        sp14, sm14 = crossings(14, 3)
        sp7, sm7 = crossings(7, 2)
        d_h4 = sp14 - (sm14 * oh).sum(-1)[..., None]
        d_s1 = sp7 - (sm7 * oh).sum(-1)[..., None]

        # S2: per-day first/second-minimum trick on the weekday row.
        iswd = t.weekday < 5
        c_base = wd_counts_of(t, oh)  # [P, 5, E]
        row_present = c_base > 0
        row_np = row_present.sum(-1)
        row_min = torch.where(row_present, c_base, torch.inf).amin(-1)
        row_score = torch.where(row_np > 1, row_min, 0.0)  # [P, 5]
        s2_base = row_score.sum(-1)
        old_rs = torch.cat([row_score, row_score.new_zeros((p, 2))], dim=1)[:, t.weekday]  # 0 on weekends
        c_day = torch.cat([c_base, c_base.new_zeros((p, 2, n_emp))], dim=1)[:, t.weekday]  # [P, D, E]
        v2 = c_day - oh * iswd[:, None].to(f32)
        p2 = v2 > 0
        np2 = p2.sum(-1)
        v2m = torch.where(p2, v2, _BIG)
        min1 = v2m.amin(-1)
        arg1 = v2m.argmin(-1)
        at1 = iota_e == arg1[..., None]
        min2 = torch.where(at1, _BIG, v2m).amin(-1)
        cand2 = v2 + 1.0
        min_new = torch.where(at1, torch.minimum(cand2, min2[..., None]), torch.minimum(min1[..., None], cand2))
        np_new2 = np2[..., None] + (v2 == 0)
        rs_new = torch.where(np_new2 > 1, min_new, 0.0)
        d_s2 = iswd[:, None].to(f32) * (rs_new - old_rs[..., None])

        # S3/S4: per-day extrema tricks on totals / weekend totals.
        tot, wk = totals(t, oh)
        pres_b = tot > 0
        np_b = pres_b.sum(-1)
        s3_base = spread_of(tot, pres_b, np_b)
        s4_base = spread_of(wk, pres_b, np_b)

        v3 = tot[:, None] - oh
        p3 = v3 > 0
        np3 = p3.sum(-1)
        v3m = torch.where(p3, v3, _BIG)
        min1_3 = v3m.amin(-1)
        at1_3 = iota_e == v3m.argmin(-1)[..., None]
        min2_3 = torch.where(at1_3, _BIG, v3m).amin(-1)
        max1_3 = torch.where(p3, v3, -_BIG).amax(-1)
        cand3 = v3 + 1.0
        min_new3 = torch.where(
            at1_3, torch.minimum(cand3, min2_3[..., None]), torch.minimum(min1_3[..., None], cand3)
        )
        max_new3 = torch.maximum(max1_3[..., None], cand3)
        np_new3 = np3[..., None] + (v3 == 0)
        d_s3 = torch.where(np_new3 >= 2, max_new3 - min_new3, 0.0) - s3_base[:, None, None]

        v4 = wk[:, None] - t.weekend_f[:, None] * oh
        v4m = torch.where(p3, v4, _BIG)
        min1_4 = v4m.amin(-1)
        at1_4 = iota_e == v4m.argmin(-1)[..., None]
        min2_4 = torch.where(at1_4, _BIG, v4m).amin(-1)
        v4x = torch.where(p3, v4, -_BIG)
        max1_4 = v4x.amax(-1)
        atx_4 = iota_e == v4x.argmax(-1)[..., None]
        max2_4 = torch.where(atx_4, -_BIG, v4x).amax(-1)
        cand4 = v4 + t.weekend_f[:, None]
        min_new4 = torch.where(
            at1_4, torch.minimum(cand4, min2_4[..., None]), torch.minimum(min1_4[..., None], cand4)
        )
        max_new4 = torch.where(
            atx_4, torch.maximum(cand4, max2_4[..., None]), torch.maximum(max1_4[..., None], cand4)
        )
        d_s4 = torch.where(np_new3 >= 2, max_new4 - min_new4, 0.0) - s4_base[:, None, None]

        noop = oh > 0  # e == a[d] is the identity move: exact delta 0
        d_hard = torch.where(noop, 0.0, d_h1 + d_h2 + d_h3 + d_h4)
        d_soft = torch.where(noop, 0.0, d_s1 + d_s2 + d_s3 + d_s4)

        cur_h, cur_s = cur_score[:, 0:1], cur_score[:, 1:2]
        ch_moves = SchedMoves(
            torch.zeros((p, d_days * n_emp), dtype=torch.bool, device=dev),
            iota_d.repeat_interleave(n_emp).expand(p, -1),
            iota_d.repeat_interleave(n_emp).expand(p, -1),
            iota_e.repeat(d_days).expand(p, -1),
        )
        # Dense batch fingerprints: fp' = fp ^ h(d, a[d]) ^ h(d, e).
        h_old0, h_old1 = position_hash_planes(iota_d.expand(p, -1), a)
        blocks = [(
            cur_h + d_hard.reshape(p, -1), cur_s + d_soft.reshape(p, -1), ch_moves,
            torch.ones((p, d_days * n_emp), dtype=torch.bool, device=dev),
            (h_old0[..., None] ^ t.h_de0).reshape(p, -1), (h_old1[..., None] ^ t.h_de1).reshape(p, -1),
        )]
        dr = draws.dense_swaps(n_rand, n_off, d_days, active)

        if n_rand > 0:
            # Unrestricted random swaps: any day pair, scored by the region path.
            rs_moves = SchedMoves(
                torch.ones((p, n_rand), dtype=torch.bool, device=dev),
                dr.rs_d1,
                (dr.rs_d1 + dr.rs_off) % d_days,
                torch.zeros((p, n_rand), dtype=torch.int64, device=dev),
            )
            rs_dh, rs_ds, (rf0, rf1) = exact_move_deltas(a, rs_moves)
            blocks.append((
                cur_h + rs_dh, cur_s + rs_ds, rs_moves,
                torch.ones((p, n_rand), dtype=torch.bool, device=dev), rf0, rf1,
            ))

        if n_off == 0:
            return _cat_blocks(blocks)

        # Swap diagonals swap(d, d + delta), delta >= 14: window-disjoint, so the
        # windowed deltas decompose into the two ChangeDay deltas; S2/S4 are
        # re-derived coupled (S3 is zero: totals are unchanged).
        delta = dr.delta  # [P, n_off]
        a_ext = torch.cat([a, a.new_full((p, d_days), -2)], dim=1)
        blk = torch.stack([d_hard, d_s1])  # [2, P, D, E]
        blk_ext = torch.cat([blk, blk.new_zeros((2, p, d_days, n_emp))], dim=2)
        wd_oh5 = _one_hot(t.weekday, 5)  # [D, 5], 0 on weekends
        hard_sw, soft_sw, a2s = [], [], []
        for j in range(n_off):
            day2 = delta[:, j : j + 1] + iota_d  # [P, D] (>= D: padding)
            a2 = a_ext.gather(1, day2)
            oh2 = _one_hot(a2, n_emp)  # -2 padding: a zero row
            blk_sh = blk_ext.gather(2, day2[None, :, :, None].expand(2, p, d_days, n_emp))
            term_a = (blk * oh2).sum(-1)   # block[d, a2]
            term_b = (blk_sh * oh).sum(-1)  # block[d + delta, a1]

            wd2 = (t.weekday + delta[:, j : j + 1]) % 7  # [P, D]
            diff = oh2 - oh
            upd = (
                c_base[:, None]
                + wd_oh5[None, :, :, None] * diff[:, :, None, :]
                - _one_hot(wd2, 5)[..., None] * diff[:, :, None, :]
            )  # [P, D, 5, E]
            s2_sw = s2_of(upd) - s2_base[:, None]
            dw = (t.weekend_f - (wd2 >= 5).to(f32))[..., None]
            s4_sw = spread_of(wk[:, None] + dw * diff, pres_b[:, None], np_b[:, None]) - s4_base[:, None]

            noop_sw = a2 == a
            hard_sw.append(torch.where(noop_sw, 0.0, term_a[0] + term_b[0]))
            soft_sw.append(torch.where(noop_sw, 0.0, term_a[1] + term_b[1] + s2_sw + s4_sw))
            a2s.append(a2)
        hard_sw, soft_sw, a2 = (torch.stack(x, dim=1) for x in (hard_sw, soft_sw, a2s))  # [P, n_off, D]
        far = iota_d + delta[..., None]
        d2_sw = far.clamp(max=d_days - 1)
        d1_b = iota_d.expand(p, n_off, d_days)
        a_b = a[:, None, :].expand(p, n_off, d_days)
        f0, f1 = _swap_fp_delta_planes(d1_b, a_b, a2, d2_sw, a2, a_b)
        sw_moves = SchedMoves(
            torch.ones((p, n_off * d_days), dtype=torch.bool, device=dev),
            d1_b.reshape(p, -1),
            d2_sw.reshape(p, -1),
            torch.zeros((p, n_off * d_days), dtype=torch.int64, device=dev),
        )
        blocks.append((
            cur_h + hard_sw.reshape(p, -1), cur_s + soft_sw.reshape(p, -1), sw_moves,
            (far <= d_days - 1).reshape(p, -1), f0.reshape(p, -1), f1.reshape(p, -1),
        ))
        return _cat_blocks(blocks)

    def move_fp(assign, cur_fp, moves, idx):
        d1, e1, n1, d2, e2, n2 = resolve_move(assign, moves, idx)
        fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
        return fp_update(fp_update(fp, d1, e1, n1), d2, e2, n2)

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
        neighborhood=nbr_fn,
        move_fp=fp_fn,
        apply_move=apply_fn,
        perturb=_make_perturb(d_days, n_emp),
        width=width,
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
