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
- **The block** goes through ``ops/nqueens_kernel.py`` where the JAX package
  takes its Pallas kernel or its slice form (a truthy ``use_pallas``, or
  ``block_impl="slice"``, the default): the CUDA kernel for a CUDA tensor, its
  plain version on the CPU, whatever the truthy ``use_pallas`` (the tensors'
  device picks).  ``block_impl="mxu_conv"`` and ``"mxu_toeplitz"``, the JAX
  package's matrix forms of the diagonal reads (an A/B for the TPU's matrix
  unit), run instead of the kernel, on the CPU and on the card, as plain torch
  ops (``matrix_block``): a grouped ``conv1d`` of each lane's dc and ac with
  one impulse row per sampled column, and a one-hot [P, A, n] ``bmm`` with two
  [P, n, n] Toeplitz tables (built every call, 1.02 GB each at P = 256, n =
  1000: an A/B arm, not a default).  Both are exact: the reads are products of
  0/1 with small integers.  On the card the conv runs with cuDNN off (its
  heuristics may take TF32, which rounds counters above 2048, or an FFT
  algorithm, which is not exact), and the ``bmm`` in full float32, PyTorch's
  default, which the port never changes.  An unknown ``block_impl`` raises
  ``ValueError``, as there (here when the problem is made).
- **The scores as a row block.** Without ``nbr_axis`` the neighborhood hands
  the engine the block as the kernel wrote it (``Neighborhood.block``, a
  ``RowBlock``: hard [P, A, n], the column mask as its row validity, the row
  minima and first argmins), with ``scores`` and ``valid`` None.  The JAX
  package returns ``make_score(hard)`` [A·n, 2] and the [A·n] mask, which XLA
  fuses into the reductions that read them; here the engine reads the block
  through ``core/problem.py``'s accessors, and no pass writes the stacked
  block.  ``hint_idx`` is K3's pick with no exclusion (``ops/block_pick.py``),
  exactly ``lex_argmin`` of the valid block: for a lane with no valid column
  it is 0, where the JAX package's row-minimum form gives that lane's
  ``row_arg[0]``.  No such lane takes its pick (its ``n_valid`` is 0), so the
  trajectories are the same.
- **The move written in place, the best carried by its board.** Without
  ``nbr_axis`` the problem has ``in_place`` (``core/problem.py``): the descent
  writes each lane's move into its own state under the mask of lanes that
  step and still run (K4, ``ops/nqueens_move.py``: one launch on the card),
  carries its best as the board ``rows`` alone, written by the same launch
  in the lanes that reach a new best and still run (``InPlace.saves_best``),
  and rebuilds the best's counters with ``build_state`` once, at its end.  The JAX package selects
  whole state trees per lane and XLA fuses the selects into ``apply_move``'s
  updates; here each select would be a pass of its own over the 8 MB state.
  The counters are exact integers in float32, so the rebuild equals the
  carried counters bit for bit and the trajectories are the same.
  ``apply_move`` stays, the JAX package's interface: the sharded neighborhood
  (``NQPairs``) and the tests use it.
- **The sample and a pick's fingerprint as kernels.** The JAX package's
  neighborhood is one XLA fusion around ``lax.top_k``; here the Gumbel
  column sample, its ``col_valid`` and ``n_valid``, and the block's inputs
  (each sampled column's row and removed term) are one call,
  ``ops/nqueens_sample.py`` (K6: one launch on the card), and ``move_fp``
  for ``NQMoves`` is one call, ``nqueens_move_fp`` in ``ops/fingerprint.py``
  (K7: the pick's decode and hash in one launch on the card, at a pick or a
  retry and over the exact filter's [P, A·n]).  On the CPU their plain
  versions run: the stable sort and the gathers, the decode and
  ``fp_update``, bit for bit what the card computes.  ``NQPairs`` keeps the
  decode and ``fp_update``.
- **``col_sampling="approx"``** samples exactly, as ``"exact"`` does.  The JAX
  package's ``jax.lax.approx_max_k`` is approximate (recall ~0.95) only on the
  TPU; on the CPU, where the reference runs, it returns ``lax.top_k``'s indices,
  and so does the port.

Without ``nbr_axis`` the problem is ``capturable`` (``core/problem.py``): on the
card the solvers replay its descent iterations as CUDA graphs; the per-device log
table is filled before any capture, by the eager first iteration.

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

from constraint_solver_tpu_torch.core.problem import InPlace, Neighborhood, Problem, RowBlock, replayable
from constraint_solver_tpu_torch.ops.block_pick import block_pick
from constraint_solver_tpu_torch.ops.fingerprint import fingerprint_i32, fp_update, nqueens_move_fp
from constraint_solver_tpu_torch.ops.lex import make_score
from constraint_solver_tpu_torch.ops.nqueens_kernel import block_from_windows, nqueens_neighborhood_scores
from constraint_solver_tpu_torch.ops.nqueens_move import nqueens_move
from constraint_solver_tpu_torch.ops.nqueens_sample import nqueens_sample
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


def _board(state: NQState) -> torch.Tensor:
    """The key of ``Problem.in_place``: a state stands for its board."""
    return state.rows


def default_log_weights(board_size: int) -> torch.Tensor:
    """log(k + 1e-4) in float32 for every possible column score k ∈ [0, 3n)."""
    return torch.log(torch.arange(3 * board_size, dtype=torch.float32) + 1e-4)


def matrix_block(block_impl: str, rc, dc, ac, c, r, removed, cur):
    """The candidate block by the JAX package's matrix form ``block_impl``
    (``"mxu_conv"`` or ``"mxu_toeplitz"``): the kernel wrapper's arguments and
    its (scores float32[P, A, n], row_min float32[P, A], row_arg int32[P, A])."""
    p, n = rc.shape
    a = c.shape[1]
    iota = torch.arange(n, device=rc.device)
    c = c.long()
    if block_impl == "mxu_conv":
        # out[p, j, r'] = sum_k imp[p, j, k] * table[p, r' + k]: an impulse at
        # k = n-1-c_j reads dc[r' - c_j + n-1], at k = c_j reads ac[r' + c_j].
        imp_d = (iota == ((n - 1) - c).unsqueeze(-1)).to(torch.float32).view(p * a, 1, n)
        imp_a = (iota == c.unsqueeze(-1)).to(torch.float32).view(p * a, 1, n)
        with torch.backends.cudnn.flags(enabled=False):
            dc_at = torch.nn.functional.conv1d(dc.unsqueeze(0), imp_d, groups=p).view(p, a, n)
            ac_at = torch.nn.functional.conv1d(ac.unsqueeze(0), imp_a, groups=p).view(p, a, n)
    elif block_impl == "mxu_toeplitz":
        # T_d[p, s, r'] = dc[p, r' + n-1 - s] and T_a[p, s, r'] = ac[p, r' + s];
        # row c_j of each is column c_j's read, taken by a one-hot product.
        onehot = (iota == c.unsqueeze(-1)).to(torch.float32)
        dc_at = torch.bmm(onehot, dc.unfold(1, n, 1).flip(1))
        ac_at = torch.bmm(onehot, ac.unfold(1, n, 1).contiguous())
    else:
        raise ValueError(f"{block_impl!r} is not a matrix form of the block")
    return block_from_windows(rc, dc_at, ac_at, r, removed, cur)


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
    A truthy ``use_pallas`` or ``block_impl="slice"`` scores the block with the
    kernel wrapper, ``block_impl="mxu_conv"``/``"mxu_toeplitz"`` otherwise by
    ``matrix_block``; ``col_sampling="approx"`` samples exactly (see the module
    docstring).  ``nbr_axis``/``nbr_shards``/``nbr_keep`` shard the
    neighborhood over that axis of the active mesh.  ``log_weights``:
    float32[3n] table of log(k + 1e-4), by default ``default_log_weights(n)``."""
    if col_sampling not in ("exact", "approx"):
        raise ValueError(f"unknown col_sampling {col_sampling!r}")
    if block_impl not in ("slice", "mxu_conv", "mxu_toeplitz"):
        raise ValueError(f"unknown block_impl {block_impl!r}")
    use_kernel = bool(use_pallas) or block_impl == "slice"
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
        n_conflicted = (cs > 0).sum(dim=-1)
        amount = n_conflicted.clamp(1, a_max)
        gumbel, num_cols = draws.neighborhood(n, amount, active)
        # Weighted sample of A columns without replacement: Gumbel top-k, ties
        # (the -inf tail of unconflicted columns included) in index order, as
        # lax.top_k takes them; with each column's row and removed term (K6).
        s = nqueens_sample(cs, log_table(rows.device), gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a_max)

        if nbr_axis is not None:
            return sharded(state, cur_score, s)
        # The block as the kernel wrote it, with no [P, A·n, 2] scores and no
        # [P, A·n] mask; the first pick (``hint_idx``) is K3's from its row minima.
        cand_hard, row_min, row_arg = block(state, cur_score, s.c, s.r, s.removed)
        row_block = RowBlock(cand_hard, s.col_valid, row_min, row_arg)
        return Neighborhood(
            scores=None,
            moves=NQMoves(s.cols, n),
            valid=None,
            hint_idx=block_pick(*row_block),
            n_valid=s.n_valid,
            block=row_block,
        )

    def block(state, cur_score, c, r, removed):
        """The block's (scores [P, A', n], row_min, row_arg) for sampled columns
        c [P, A'] (int32) on rows r with their removed terms."""
        args = (state.rc, state.dc, state.ac, c, r, removed, cur_score[:, 0].contiguous())
        if use_kernel:
            return nqueens_neighborhood_scores(*args)
        return matrix_block(block_impl, *args)

    def sharded(state, cur_score, s):
        """This rank's A/shards columns of the sample ``s``, its ``nbr_keep``
        best candidates, and every rank's gathered over the axis."""
        axis = active_axis(nbr_axis, nbr_shards)
        p = s.cols.shape[0]
        mine = slice(axis.index * a_local, (axis.index + 1) * a_local)
        c, col_valid = s.cols[:, mine], s.col_valid[:, mine]
        hard = block(state, cur_score, *(t[:, mine].contiguous() for t in (s.c, s.r, s.removed)))[0]
        hard = hard.reshape(p, a_local * n)
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
        if isinstance(moves, NQMoves):  # the decode and the hash in one call (K7)
            return nqueens_move_fp(cur_fp, moves.cols, state.rows, idx)
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
        neighborhood=replayable(neighborhood),
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=a_max * n,
        capturable=nbr_axis is None,
        in_place=InPlace(move=nqueens_move, key=_board, rebuild=build_state, saves_best=True)
        if nbr_axis is None else None,
    )
