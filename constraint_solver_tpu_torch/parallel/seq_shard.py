"""Date-axis sharded schedule scoring (port of ``constraint_solver_tpu/parallel/seq_shard.py``).

The schedule's long axis is its days, scored with sliding windows of 2, 7, 9
and 14 days.  Over a ``seq`` axis of the mesh (``parallel/mesh.py``) every rank
holds ⌈D/S⌉ contiguous days (the last rank's padding days hold -1, a zero
one-hot row) and the same slices of the static tables:

- one ``ppermute`` sends each rank's first 13 days and its first weekend flag
  to its predecessor, so every window that starts on a rank is scored there;
  window starts past the schedule's end are masked by their global day;
- the day-local terms (H1–H4, S1) and the employee-level count matrices (the
  weekday × employee counts of S2, the totals and weekend totals of S3/S4)
  are summed over the axis in one ``all_reduce``, and S2–S4 are finished on
  every rank, so every rank returns the same global (hard, soft).

Every term is a small integer in float32, so the result equals the one-device
scorer (``models/scheduling.py``) bit for bit.  ``sharded_score`` is the
per-rank body the date-sharded solver (``parallel/seq_solver.py``) shares.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from constraint_solver_tpu_torch.models.scheduling import PAD, ScheduleSpec, _one_hot, s2_of, s34_of
from constraint_solver_tpu_torch.ops.lex import make_score
from constraint_solver_tpu_torch.parallel.mesh import Axis, Mesh, all_reduce, ppermute

HALO = PAD  # the widest window (14 days) less one


class DayTables(NamedTuple):
    """The static tables over d_pad = S·local days (zeros past the schedule)."""

    holiday: torch.Tensor   # float32[d_pad, E]
    weekend: torch.Tensor   # bool[d_pad]
    weekday: torch.Tensor   # int64[d_pad], 6 past the schedule (no weekday row)
    wk_pad: torch.Tensor    # bool[d_pad + 2·PAD], the weekend flags shifted by PAD


def day_tables(spec: ScheduleSpec, d_pad: int, device) -> DayTables:
    d, e = spec.num_days, spec.num_employees
    holiday = np.zeros((d_pad, e), np.float32)
    holiday[:d] = spec.holiday_array().T
    weekend = np.zeros((d_pad,), bool)
    weekend[:d] = spec.is_weekend()
    weekday = np.full((d_pad,), 6, np.int64)
    weekday[:d] = spec.weekdays()
    wk_pad = np.zeros((d_pad + 2 * PAD,), bool)
    wk_pad[PAD : PAD + d] = spec.is_weekend()
    return DayTables(*(torch.as_tensor(x, device=device) for x in (holiday, weekend, weekday, wk_pad)))


def local_days(spec: ScheduleSpec, n_shards: int) -> int:
    """Days per rank, ⌈D/S⌉; raises ``ValueError`` below the 13-day halo."""
    local = -(-spec.num_days // n_shards)
    if local < HALO:
        raise ValueError(
            f"each shard needs >= {HALO} days; got {local} ({spec.num_days} days over {n_shards} shards)"
        )
    return local


def aggregates(a_loc: torch.Tensor, t: DayTables, start: int, n_emp: int) -> torch.Tensor:
    """This rank's share of the employee-level counts [P, 7E]: weekday ×
    employee counts (5E), totals (E) and weekend totals (E)."""
    local = a_loc.shape[1]
    oh = _one_hot(a_loc, n_emp)  # [P, local, E]
    wd = oh.new_zeros((a_loc.shape[0], 7, n_emp)).index_add_(1, t.weekday[start : start + local], oh)[:, :5]
    tot = oh.sum(1)
    wk = (oh * t.weekend[start : start + local, None].to(torch.float32)).sum(1)
    return torch.cat([wd.flatten(1), tot, wk], dim=1)


def finish_aggregates(agg: torch.Tensor, n_emp: int):
    """(wd_counts [P, 5, E], tot [P, E], wk [P, E]) from summed ``aggregates``."""
    return agg[:, : 5 * n_emp].reshape(-1, 5, n_emp), agg[:, 5 * n_emp : 6 * n_emp], agg[:, 6 * n_emp :]


def sharded_score(a_loc: torch.Tensor, t: DayTables, axis: Axis, d_days: int, n_emp: int) -> torch.Tensor:
    """The global (hard, soft) [P, 2] of assignments whose days are sharded
    over ``axis``, from this rank's slice a_loc [P, local]: two collectives."""
    f32 = torch.float32
    p, local = a_loc.shape
    start = axis.index * local
    g = start + torch.arange(local, device=a_loc.device)
    wkd = t.weekend[start : start + local]

    halo = ppermute(torch.cat([a_loc[:, :HALO], wkd[:1].long().expand(p, 1)], dim=1), axis, -1)
    ext = torch.cat([a_loc, halo[:, :HALO]], dim=1)                # [P, local + 13]
    wk_ext = torch.cat([wkd.expand(p, local), halo[:, HALO:].bool()], dim=1)  # [P, local + 1]
    oh = _one_hot(a_loc, n_emp)
    oh_ext = _one_hot(ext, n_emp)

    h1 = (oh * t.holiday[start : start + local]).sum((1, 2))
    h2 = torch.where(g < d_days - 1, ext[:, :local] == ext[:, 1 : local + 1], False).sum(-1)
    cond = wk_ext[:, :local] & wk_ext[:, 1 : local + 1] & (g <= d_days - 9)
    e17 = ext[:, :local] == ext[:, 7 : local + 7]
    e18 = ext[:, :local] == ext[:, 8 : local + 8]
    e27 = ext[:, 1 : local + 1] == ext[:, 7 : local + 7]
    e28 = ext[:, 1 : local + 1] == ext[:, 8 : local + 8]
    h3 = torch.where(cond, e17.to(f32) + e18 + e27 + e28, 0.0).sum(-1)
    csum = torch.cat([oh_ext.new_zeros((p, 1, n_emp)), oh_ext.cumsum(1)], dim=1)
    win14 = csum[:, 14 : local + 14] - csum[:, :local]
    h4 = torch.where((g <= d_days - 14)[:, None], win14 > 3, False).sum((1, 2))
    win7 = csum[:, 7 : local + 7] - csum[:, :local]
    s1 = torch.where((g <= d_days - 7)[:, None], win7 > 2, False).sum((1, 2))

    terms = torch.cat([(h1 + h2 + h3 + h4)[:, None], s1[:, None].to(f32), aggregates(a_loc, t, start, n_emp)], 1)
    terms = all_reduce(terms, axis)
    wd_counts, tot, wk = finish_aggregates(terms[:, 2:], n_emp)
    return make_score(terms[:, 0], terms[:, 1] + s2_of(wd_counts) + s34_of(tot, wk))


def make_sharded_schedule_score(spec: ScheduleSpec, mesh: Mesh, axis: str = "seq"):
    """Returns ``score(assign)``: the (hard, soft) of int assignments [D] or
    [P, D] (a tensor, whose device the scoring runs on), computed with the
    days sharded over ``mesh``'s ``axis``.  Every rank of the axis calls it
    with the same assignments and gets the same scores."""
    ax = mesh.axis(axis)
    d_days, n_emp = spec.num_days, spec.num_employees
    local = local_days(spec, ax.size)
    d_pad = local * ax.size
    tables: dict[torch.device, DayTables] = {}

    def score(assign: torch.Tensor) -> torch.Tensor:
        a = torch.as_tensor(assign).long()
        batch = a[None] if a.dim() == 1 else a
        if a.device not in tables:
            tables[a.device] = day_tables(spec, d_pad, a.device)
        a_pad = torch.cat([batch, batch.new_full((batch.shape[0], d_pad - d_days), -1)], dim=1)
        out = sharded_score(a_pad[:, ax.index * local : (ax.index + 1) * local], tables[a.device], ax, d_days, n_emp)
        return out[0] if a.dim() == 1 else out

    return score
