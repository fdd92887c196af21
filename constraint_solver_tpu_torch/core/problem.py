"""The problem-domain interface of the solver core
(port of ``constraint_solver_tpu/core/problem.py``).

The contract is the JAX package's, with every tensor batched over a leading lane
axis P instead of being ``vmap``ped:

- a *solution* is a ``NamedTuple`` of tensors ("state"), each leaf [P, ...];
- a *score* is ``float32[P, 2]`` = (hard, soft), minimized lexicographically;
- a *neighborhood* is a batch of W candidate moves per lane with their scores;
- *apply_move* applies only the chosen move of each lane.

Divergences:

- randomness comes from a ``Draws`` source (``utils/draws.py``) instead of a key,
  and ``neighborhood`` also takes the [P] mask of lanes still in their descent,
  which a draw source that follows JAX keys needs;
- ``Neighborhood.moves`` is opaque to the engine and may be implicit: the
  N-Queens moves are the sampled columns [P, A] plus n, and flat candidate
  ``idx`` is the move (column ``cols[idx // n]``, row ``idx % n``), so no
  [P, A·n] move arrays are built.  The engine only hands ``moves`` back to
  ``move_fp`` and ``apply_move``;
- the optional field ``in_place`` (an ``InPlace``) lets a problem skip the
  descent's whole-state selects: QAP's incremental G and H, carried by the
  permutation, and N-Queens without ``nbr_axis``, whose move K4 writes
  (``ops/nqueens_move.py``) and whose best is carried by the board.
  The JAX package selects whole state trees per lane, and XLA fuses each select
  into the update that feeds it; eagerly or in a CUDA graph each select is a
  pass of its own over the state.  With the field the engine writes the move in
  place under the lane mask and carries the descent's best as a key, from which
  it rebuilds the state once at the end (with ``InPlace.saves_best`` the move
  writes that key too: N-Queens' K4 writes the best board in the same
  launch).  The answers are the same: the masked move leaves the other lanes
  bit for bit as they were, and the rebuild gives the state the key stands
  for;
- a neighborhood may hand its scores over as a row block (``Neighborhood.block``,
  a ``RowBlock``: N-Queens' B1 output, hard [P, R, C] with a soft channel that
  is identically 0, a validity per row, each row's minimum and first argmin)
  and leave ``scores`` and ``valid`` None.  The JAX package always hands over
  ``make_score(hard)`` and its [W] mask, and XLA fuses the stack into the
  reductions that read it; eagerly or in a CUDA graph the stack is a pass that
  writes the whole [P, W, 2] block.  The engine reads a neighborhood only
  through four accessors: ``all_scores`` and ``all_valid`` build the block and
  the mask on demand (the exact filter, which reads every candidate),
  ``score_at`` reads one score a lane, and ``pick`` takes the best candidate
  with an exclusion list, for a row block by K3 (``ops/block_pick.py``: one
  launch on the card, reading the row minima).  The picks and scores are the
  same bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from constraint_solver_tpu_torch.ops.block_pick import block_pick, excluded
from constraint_solver_tpu_torch.ops.lex import lex_argmin, make_score


class RowBlock(NamedTuple):
    """Candidate scores as rows (``Neighborhood.block``): flat candidate
    ``i = j * C + k`` is row j's entry k, its score (hard[:, j, k], 0).

    hard:      float32[P, R, C].
    row_valid: bool[P, R]: every candidate of row j is valid, or none is.
    row_min:   float32[P, R], each row's minimum of ``hard``.
    row_arg:   int32[P, R], the first index of it in the row.
    """

    hard: torch.Tensor
    row_valid: torch.Tensor
    row_min: torch.Tensor
    row_arg: torch.Tensor


class Neighborhood(NamedTuple):
    """A scored batch of W candidate moves per lane.

    scores:    float32[P, W, 2] candidate (hard, soft) scores, or None with ``block``.
    moves:     whatever the problem's ``move_fp``/``apply_move`` decode a flat
               candidate index with.
    valid:     bool[P, W] — invalid candidates are never selected; None with ``block``.
    hint_idx:  optional int64[P], exactly ``lex_argmin(scores, valid)`` with
               first-index ties, when the proposer has it more cheaply.
    n_valid:   optional int64[P], the exact count of True in ``valid``.
    fp_deltas: optional int64[P, W, 2]: candidate ``i``'s fingerprint is
               ``current_fp ^ fp_deltas[:, i]``; the engine then runs the exact
               tabu filter.
    block:     optional ``RowBlock`` standing for ``scores`` and ``valid``
               (W = R·C), which are then None.

    The engine reads the scores only through the accessors below.
    """

    scores: torch.Tensor | None
    moves: Any
    valid: torch.Tensor | None
    hint_idx: torch.Tensor | None = None
    n_valid: torch.Tensor | None = None
    fp_deltas: torch.Tensor | None = None
    block: RowBlock | None = None

    def all_scores(self) -> torch.Tensor:
        """float32[P, W, 2], built from the row block when there is one."""
        if self.block is None:
            return self.scores
        hard = self.block.hard
        return make_score(hard.reshape(hard.shape[0], -1))

    def all_valid(self) -> torch.Tensor:
        """bool[P, W], built from the row block when there is one."""
        if self.block is None:
            return self.valid
        p, r, c = self.block.hard.shape
        return self.block.row_valid[:, :, None].expand(p, r, c).reshape(p, r * c)

    def score_at(self, idx: torch.Tensor) -> torch.Tensor:
        """float32[P, 2]: each lane's candidate ``idx[p]``."""
        lane = torch.arange(idx.shape[0], device=idx.device)
        if self.block is None:
            return self.scores[lane, idx]
        hard = self.block.hard
        return make_score(hard.reshape(hard.shape[0], -1)[lane, idx])

    def pick(self, excl: torch.Tensor | None = None) -> torch.Tensor:
        """int64[P]: ``lex_argmin`` of the valid candidates with the indices in
        ``excl`` [P, E] removed (-1 slots never match); by K3 for a row block."""
        if self.block is not None:
            return block_pick(*self.block, excl)
        return lex_argmin(self.scores, excluded(self.valid, excl))


class InPlace(NamedTuple):
    """A descent whose state is written in place and whose best is carried by
    a key (``Problem.in_place``).

    move:    (state, moves, idx[P], mask[P]) -> None.  ``apply_move`` in the
             lanes of ``mask`` only, written into ``state``'s own buffers;
             every other lane stays bit for bit as it was.  The engine owns the
             descent's state, ignores what the call returns, and reads nothing
             of the old state after it.
    key:     (state) -> key, a smaller tree that stands for ``state``.
    rebuild: (key) -> state, exactly the state the key stands for.  The
             descent carries its best as the key and rebuilds it once, at its
             end.
    saves_best: the move also writes the descent's best key in place:
             move(state, moves, idx, mask, best=key, save=save[P]) writes
             ``key(state)`` after the move into the key ``best`` in the lanes
             of ``save`` (a lane outside ``mask`` writes its key as it is),
             and leaves every other lane of ``best`` as it was.  The engine
             then selects no best key (N-Queens: the board, written by K4 in
             the same launch).  False (the default): the engine selects the
             best key from ``key(state)`` itself (QAP).
    """

    move: Callable
    key: Callable
    rebuild: Callable
    saves_best: bool = False


class Problem(NamedTuple):
    """A constraint problem as functions on lane-batched tensors.

    init:         (draws) -> state                     random initial solutions
    score:        (state) -> float32[P, 2]
    is_best:      (score[..., 2]) -> bool[...]          early-exit predicate
    fingerprint:  (state) -> int64[P, 2]
    neighborhood: (state, score[P, 2], draws, active[P]) -> Neighborhood
    move_fp:      (state, cur_fp[P, 2], moves, idx[P, ...]) -> int64[P, ..., 2]
    apply_move:   (state, moves, idx[P]) -> state
    perturb:      (state, is_elite[P], draws) -> state
    name:         domain name for logs and benchmarks.
    width:        candidate moves scored per lane per local-search iteration.
    capturable:   every function of a descent iteration (``neighborhood``,
                  ``move_fp``, ``apply_move``, ``is_best``) issues device work
                  only: no host read, no copy from the host, no collective.  On
                  a CUDA device the solvers then replay the iteration as CUDA
                  graphs (``core/graphed.py``).  A replayed iteration does not
                  run ``neighborhood``; it calls ``neighborhood(None, None,
                  None, None)``, which must return at once, so that whatever
                  wraps ``neighborhood`` (a counter, a profiler span) still
                  sees one call per iteration (``replayable`` gives a
                  neighborhood that form).
    in_place:     optional ``InPlace``: the descent writes its move in place
                  under the lane mask and carries its best as a key, instead of
                  selecting whole states per lane.
    """

    name: str
    init: Callable
    score: Callable
    is_best: Callable
    fingerprint: Callable
    neighborhood: Callable
    move_fp: Callable
    apply_move: Callable
    perturb: Callable
    width: int = 0
    capturable: bool = False
    in_place: InPlace | None = None


def replayable(neighborhood: Callable) -> Callable:
    """``neighborhood`` that returns None at once when a replayed iteration
    calls it as ``neighborhood(None, None, None, None)`` (``Problem.capturable``)."""

    def call(state, cur_score, draws, active):
        if state is None:
            return None
        return neighborhood(state, cur_score, draws, active)

    return call
