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
- the optional field ``in_place`` (an ``InPlace``) lets a problem whose state
  is large (QAP's incremental G and H) skip the descent's whole-state selects.
  The JAX package selects whole state trees per lane, and XLA fuses each select
  into the update that feeds it; eagerly or in a CUDA graph each select is a
  pass of its own over the state.  With the field the engine writes the move in
  place under the lane mask and carries the descent's best as a key, from which
  it rebuilds the state once at the end.  The answers are the same: the masked
  move leaves the other lanes bit for bit as they were, and the rebuild gives
  the state the key stands for.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Neighborhood(NamedTuple):
    """A scored batch of W candidate moves per lane.

    scores:    float32[P, W, 2] candidate (hard, soft) scores.
    moves:     whatever the problem's ``move_fp``/``apply_move`` decode a flat
               candidate index with.
    valid:     bool[P, W] — invalid candidates are never selected.
    hint_idx:  optional int64[P], exactly ``lex_argmin(scores, valid)`` with
               first-index ties, when the proposer has it more cheaply.
    n_valid:   optional int64[P], the exact count of True in ``valid``.
    fp_deltas: optional int64[P, W, 2]: candidate ``i``'s fingerprint is
               ``current_fp ^ fp_deltas[:, i]``; the engine then runs the exact
               tabu filter.
    """

    scores: torch.Tensor
    moves: Any
    valid: torch.Tensor
    hint_idx: torch.Tensor | None = None
    n_valid: torch.Tensor | None = None
    fp_deltas: torch.Tensor | None = None


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
    """

    move: Callable
    key: Callable
    rebuild: Callable


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
