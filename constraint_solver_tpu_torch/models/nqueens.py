"""N-Queens with O(1)-delta neighborhood scoring
(port of ``constraint_solver_tpu/models/nqueens.py``).

Same semantics as the JAX package: one queen per column (``rows[col] = row``),
score = sum over row/diagonal/anti-diagonal lines of k·(k−1) (each attacking pair
counted twice), conflicted columns sampled by Gumbel top-k weighted by conflict
count, every row of every sampled column scored as one [A, n] block, and the
counters carried incrementally through ``apply_move``.  Every function takes
lane-batched tensors [P, ...].

Divergences from the JAX package:

- **Implicit moves.** ``Neighborhood.moves`` is ``NQMoves(cols[P, A], n)``; flat
  candidate ``idx`` is column ``cols[idx // n]`` moved to row ``idx % n``.  The
  JAX package builds the [A·n] column and row arrays.
- **Draws.** Random numbers come from a ``Draws`` source (``utils/draws.py``).
- **Log weights from a table.** The column weights log(cs + 1e-4) depend only on
  the integer column score cs ∈ [0, 3n), so they are read from a per-problem
  table computed once on the CPU.  The same table serves every device, so the
  port's CPU and CUDA runs agree.  XLA's float32 ``log`` differs from PyTorch's
  (correctly rounded here) in the last bit on a few percent of these inputs, so
  tests against the JAX package pass the reference's table as ``log_weights``.
- **Counters by scatter.** ``line_counts`` is a ``scatter_add_`` (float adds of
  1.0 are exact in any order), not the TPU's one-hot reduction.
- **Boards are int64**, PyTorch's index type (int32 in the JAX package).
- **The block** always goes through ``ops/nqueens_kernel.py``: the CUDA kernel
  for a CUDA tensor, its plain version on the CPU.  The JAX package's
  ``block_impl="mxu_conv"/"mxu_toeplitz"``, ``col_sampling="approx"`` and
  ``nbr_axis`` are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, fp_update
from constraint_solver_tpu_torch.ops.lex import first_true, make_score
from constraint_solver_tpu_torch.ops.nqueens_kernel import nqueens_neighborhood_scores


class NQState(NamedTuple):
    """Board plus incrementally maintained counters, each [P, ...]."""

    rows: torch.Tensor  # int64[P, n]
    rc: torch.Tensor    # float32[P, n]      row occupancy
    dc: torch.Tensor    # float32[P, 2n-1]   diagonal occupancy (r - c + n-1)
    ac: torch.Tensor    # float32[P, 2n-1]   anti-diagonal occupancy (r + c)
    cs: torch.Tensor    # float32[P, n]      per-column conflict counts


class NQMoves(NamedTuple):
    """Implicit candidate moves: flat ``idx`` moves column ``cols[idx // n]``
    to row ``idx % n``."""

    cols: torch.Tensor  # int64[P, A] sampled columns
    n: int


def line_counts(rows: torch.Tensor):
    """Occupancy counters (rc[..., n], dc[..., 2n-1], ac[..., 2n-1]) of boards
    rows[..., n]."""
    n = rows.shape[-1]
    flat = rows.reshape(-1, n)
    cols = torch.arange(n, device=rows.device)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=rows.device)

    def count(idx, size):
        out = torch.zeros((flat.shape[0], size), dtype=torch.float32, device=rows.device)
        return out.scatter_add_(1, idx, ones).view(*rows.shape[:-1], size)

    return count(flat, n), count(flat - cols + (n - 1), 2 * n - 1), count(flat + cols, 2 * n - 1)


def _sum_pairs(counts: torch.Tensor) -> torch.Tensor:
    return (counts * (counts - 1)).sum(dim=-1)


def total_conflicts(rows: torch.Tensor) -> torch.Tensor:
    """Total conflict count (each attacking pair twice), int32[...]."""
    rc, dc, ac = line_counts(rows)
    return (_sum_pairs(rc) + _sum_pairs(dc) + _sum_pairs(ac)).to(torch.int32)


def _col_scores_from_counts(rows, rc, dc, ac) -> torch.Tensor:
    """Column c conflicts with (rc-1)+(dc-1)+(ac-1) other queens."""
    n = rows.shape[-1]
    cols = torch.arange(n, device=rows.device)
    return (
        (rc.gather(-1, rows) - 1)
        + (dc.gather(-1, rows - cols + (n - 1)) - 1)
        + (ac.gather(-1, rows + cols) - 1)
    )


def col_scores(rows: torch.Tensor) -> torch.Tensor:
    """Per-column conflict counts, int32[..., n]."""
    return _col_scores_from_counts(rows, *line_counts(rows)).to(torch.int32)


def build_state(rows: torch.Tensor) -> NQState:
    """The full counter state of boards rows[P, n] (init, perturbation, restart)."""
    rows = rows.long()
    rc, dc, ac = line_counts(rows)
    return NQState(rows=rows, rc=rc, dc=dc, ac=ac, cs=_col_scores_from_counts(rows, rc, dc, ac))


def default_log_weights(board_size: int) -> torch.Tensor:
    """log(k + 1e-4) in float32 for every possible column score k ∈ [0, 3n)."""
    return torch.log(torch.arange(3 * board_size, dtype=torch.float32) + 1e-4)


def make_nqueens_problem(
    board_size: int,
    sample_cols: int | None = None,
    log_weights=None,
) -> Problem:
    """Build the N-Queens problem.  ``sample_cols`` (A) is the number of
    conflicted columns sampled per proposal, ``max(1, n // 20)`` by default.
    ``log_weights``: float32[3n] table of log(k + 1e-4), by default
    ``default_log_weights(n)`` (see the module docstring)."""
    n = board_size
    a_max = sample_cols if sample_cols is not None else max(1, n // 20)
    table_cpu = (
        default_log_weights(n)
        if log_weights is None
        else torch.tensor(log_weights, dtype=torch.float32).reshape(-1)
    )
    if table_cpu.shape[0] < 3 * n:
        raise ValueError(f"log_weights needs {3 * n} entries, got {table_cpu.shape[0]}")
    tables: dict[torch.device, torch.Tensor] = {}

    def log_table(device: torch.device) -> torch.Tensor:
        if device not in tables:
            tables[device] = table_cpu.to(device)
        return tables[device]

    def init(draws):
        return build_state(draws.permutation(n))

    def score(state):
        return make_score(_sum_pairs(state.rc) + _sum_pairs(state.dc) + _sum_pairs(state.ac))

    def is_best(s):
        return s[..., 0] == 0

    def fingerprint(state):
        return fingerprint_i32(state.rows)

    def neighborhood(state, cur_score, draws, active):
        rows, rc, dc, ac, cs = state
        p = rows.shape[0]
        device = rows.device
        conflicted = cs > 0
        n_conflicted = conflicted.sum(dim=-1)

        # Weighted sample of A columns without replacement: Gumbel top-k.  A
        # stable descending sort takes ties, the -inf tail of unconflicted
        # columns included, in index order, as lax.top_k does.
        logits = torch.where(conflicted, log_table(device)[cs.long()], -torch.inf)
        amount = n_conflicted.clamp(1, a_max)
        gumbel, num_cols = draws.neighborhood(n, amount, active)
        c = torch.sort(logits + gumbel, dim=-1, descending=True, stable=True).indices[:, :a_max]
        col_valid = torch.arange(a_max, device=device) < torch.minimum(num_cols, n_conflicted)[:, None]

        r = rows.gather(1, c)
        d = r - c + (n - 1)
        a = r + c
        removed = (rc.gather(1, r) - 1) + (dc.gather(1, d) - 1) + (ac.gather(1, a) - 1)
        cand_hard, row_min, row_arg = nqueens_neighborhood_scores(
            rc, dc, ac, c.to(torch.int32), r.to(torch.int32), removed,
            cur_score[:, 0].contiguous(),
        )

        # First pick (Neighborhood.hint_idx): the flat first-index argmin of the
        # valid block, from the per-row minima.
        row_min_v = torch.where(col_valid, row_min, torch.inf)
        j_best = first_true(row_min_v == row_min_v.amin(dim=-1, keepdim=True))
        hint_idx = j_best * n + row_arg.gather(1, j_best[:, None]).squeeze(1).long()

        valid = col_valid[:, :, None].expand(p, a_max, n).reshape(p, a_max * n)
        return Neighborhood(
            scores=make_score(cand_hard.reshape(p, a_max * n)),
            moves=NQMoves(c, n),
            valid=valid,
            hint_idx=hint_idx,
            n_valid=col_valid.sum(dim=-1) * n,
        )

    def _decode(state, moves, idx):
        """(column, old row, new row) of flat candidates idx[P, ...]."""
        flat = idx.reshape(idx.shape[0], -1)
        col = moves.cols.gather(1, flat // moves.n)
        old = state.rows.gather(1, col)
        return col.view(idx.shape), old.view(idx.shape), idx % moves.n

    def move_fp(state, cur_fp, moves, idx):
        col, old, new = _decode(state, moves, idx)
        fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
        return fp_update(fp, col, old, new)

    def apply_move(state, moves, idx):
        """Apply each lane's move (col: r_old -> r_new) with O(1) counter
        updates and an O(n) column-score fix-up."""
        rows, rc, dc, ac, cs = state
        lane = torch.arange(rows.shape[0], device=rows.device)
        col, r_old, r_new = _decode(state, moves, idx)
        d_old, d_new = r_old - col + (n - 1), r_new - col + (n - 1)
        a_old, a_new = r_old + col, r_new + col

        rows2 = rows.clone()
        rows2[lane, col] = r_new
        rc2, dc2, ac2 = rc.clone(), dc.clone(), ac.clone()
        for t, old, new in ((rc2, r_old, r_new), (dc2, d_old, d_new), (ac2, a_old, a_new)):
            t[lane, old] -= 1.0
            t[lane, new] += 1.0

        # -1 per line shared with the vacated square, +1 per line shared with
        # the occupied one, for every unchanged column.
        iota = torch.arange(n, device=rows.device)
        dj = rows - iota + (n - 1)
        aj = rows + iota

        def eq(x, v):
            return (x == v[:, None]).to(torch.float32)

        delta_cs = (
            eq(rows, r_new) - eq(rows, r_old)
            + eq(dj, d_new) - eq(dj, d_old)
            + eq(aj, a_new) - eq(aj, a_old)
        )
        cs2 = cs + delta_cs
        cs2[lane, col] = (rc2[lane, r_new] - 1) + (dc2[lane, d_new] - 1) + (ac2[lane, a_new] - 1)
        return NQState(rows=rows2, rc=rc2, dc=dc2, ac=ac2, cs=cs2)

    def perturb(state, is_elite, draws):
        # {ChangeSubset: 100, DoNothing: 10}; k ~ U[1, n/20] near elites,
        # else U[1, n/2]; the k positions with the smallest draws change.
        hi = torch.where(is_elite, max(1, n // 20), max(1, n // 2))
        dr = draws.perturb(n, hi)
        do_change = dr.u_strat < (100.0 / 110.0)
        kth = torch.sort(dr.u, dim=-1).values.gather(1, (dr.n_alter - 1)[:, None])
        alter = do_change[:, None] & (dr.u <= kth)
        return build_state(torch.where(alter, dr.new_rows, state.rows))

    return Problem(
        name=f"nqueens-{n}",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=neighborhood,
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=a_max * n,
    )
