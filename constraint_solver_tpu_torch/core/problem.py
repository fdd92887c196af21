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
  ``move_fp`` and ``apply_move``.
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
