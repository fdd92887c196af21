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
  for a CUDA tensor, its plain version on the CPU, so ``use_pallas`` is
  accepted and ignored (the tensors' device picks the kernel).  The JAX
  package's ``col_sampling="approx"`` (``jax.lax.approx_max_k``) and
  ``block_impl="mxu_conv"``/``"mxu_toeplitz"`` (TPU matrix-unit A/Bs of the
  block) raise ``NotImplementedError``; an unknown ``block_impl`` raises
  ``ValueError``, as there.

The sharded neighborhood (``nbr_axis``, ``nbr_shards``, ``nbr_keep``), as in the
JAX package: A pads up to a multiple of the shard count, every rank of the
active mesh's ``nbr_axis`` draws the same column sample and scores its A/shards
slice of it through the kernel, keeps its ``nbr_keep`` best flat candidates
(``lax.top_k``'s order: the lowest index first among ties, invalid candidates
last) and gathers (score, column, row, valid) over the axis in one collective.
The engine gets that small list with no ``hint_idx`` or ``n_valid``, and its
moves are explicit (``NQPairs``), so ``move_fp`` and ``apply_move`` need no
collective.  ``width`` stays A·n.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.core.problem import Neighborhood, Problem
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, fp_update
from constraint_solver_tpu_torch.ops.lex import first_true, make_score
from constraint_solver_tpu_torch.ops.nqueens_kernel import nqueens_neighborhood_scores
from constraint_solver_tpu_torch.parallel.mesh import active_axis, gather_best


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


class NQPairs(NamedTuple):
    """Explicit candidate moves (the sharded neighborhood's gathered list):
    ``idx`` moves column ``cols[idx]`` to row ``rows[idx]``."""

    cols: torch.Tensor  # int64[P, W]
    rows: torch.Tensor  # int64[P, W]


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


def state_conflicts(state: NQState) -> torch.Tensor:
    """Total conflicts float32[P] from the carried counters."""
    return _sum_pairs(state.rc) + _sum_pairs(state.dc) + _sum_pairs(state.ac)


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
    use_pallas: bool | str = False,
    nbr_axis: str | None = None,
    nbr_shards: int = 1,
    nbr_keep: int = 64,
    col_sampling: str = "exact",
    block_impl: str = "slice",
    log_weights=None,
) -> Problem:
    """Build the N-Queens problem.  ``sample_cols`` (A) is the number of
    conflicted columns sampled per proposal, ``max(1, n // 20)`` by default.
    ``use_pallas`` is ignored; ``col_sampling`` and ``block_impl`` take the
    JAX package's defaults only; ``nbr_axis``/``nbr_shards``/``nbr_keep``
    shard the neighborhood over that axis of the active mesh (see the module
    docstring).  ``log_weights``: float32[3n] table of log(k + 1e-4), by
    default ``default_log_weights(n)``."""
    del use_pallas  # the tensors' device picks the kernel
    if col_sampling == "approx":
        raise NotImplementedError(
            "col_sampling='approx' is jax.lax.approx_max_k, a TPU partial reduction; the port samples exactly"
        )
    if col_sampling != "exact":
        raise ValueError(f"unknown col_sampling {col_sampling!r}")
    if block_impl in ("mxu_conv", "mxu_toeplitz"):
        raise NotImplementedError(
            f"block_impl={block_impl!r} is a TPU matrix-unit form of the block; the port scores it with its kernel"
        )
    if block_impl != "slice":
        raise ValueError(f"unknown block_impl {block_impl!r}")
    n = board_size
    a_max = sample_cols if sample_cols is not None else max(1, n // 20)
    if nbr_axis is not None:
        # Pad A up so every shard gets an equal slice.
        a_max = -(-a_max // nbr_shards) * nbr_shards
    a_local = a_max // nbr_shards
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
        return make_score(state_conflicts(state))

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

        if nbr_axis is not None:
            return sharded(state, cur_score, c, col_valid)
        cand_hard, row_min, row_arg = block(state, cur_score, c)

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

    def block(state, cur_score, c):
        """The kernel's (scores [P, A', n], row_min, row_arg) for sampled columns c [P, A']."""
        rows, rc, dc, ac, _ = state
        r = rows.gather(1, c)
        removed = (rc.gather(1, r) - 1) + (dc.gather(1, r - c + (n - 1)) - 1) + (ac.gather(1, r + c) - 1)
        return nqueens_neighborhood_scores(
            rc, dc, ac, c.to(torch.int32), r.to(torch.int32), removed, cur_score[:, 0].contiguous()
        )

    def sharded(state, cur_score, c, col_valid):
        """This rank's A/shards columns, its ``nbr_keep`` best candidates, and
        every rank's gathered over the axis."""
        axis = active_axis(nbr_axis, nbr_shards)
        p = c.shape[0]
        mine = slice(axis.index * a_local, (axis.index + 1) * a_local)
        c, col_valid = c[:, mine].contiguous(), col_valid[:, mine]
        hard = block(state, cur_score, c)[0].reshape(p, a_local * n)
        valid = col_valid[:, :, None].expand(p, a_local, n).reshape(p, a_local * n)
        hard, valid, cols, new_rows = gather_best(
            hard, valid, min(nbr_keep, a_local * n), lambda keep: (c.gather(1, keep // n), keep % n), axis
        )
        return Neighborhood(scores=make_score(hard), moves=NQPairs(cols, new_rows), valid=valid)

    def _decode(state, moves, idx):
        """(column, old row, new row) of flat candidates idx[P, ...]."""
        flat = idx.reshape(idx.shape[0], -1)
        if isinstance(moves, NQPairs):
            col, new = moves.cols.gather(1, flat), moves.rows.gather(1, flat)
        else:
            col, new = moves.cols.gather(1, flat // moves.n), flat % moves.n
        old = state.rows.gather(1, col)
        return col.view(idx.shape), old.view(idx.shape), new.view(idx.shape)

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
        dr = draws.perturb(n, hi, n)
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
