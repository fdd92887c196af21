"""Dense tabu ring and elite archive, batched over lanes
(port of ``constraint_solver_tpu/core/history.py``).

Same semantics as the JAX package, every field with a leading lane axis P:

- ``TabuRing``: a ring of fingerprints with iteration stamps; a fingerprint
  already in the ring refreshes its stamp in place; membership is equality with
  an age cutoff (the reference's intended tabu semantics, see the JAX module).
- ``EliteArchive``: K slots of (score, fingerprint, state) with a validity mask;
  insert fills the first free slot, else replaces the worst entry iff the new
  score is <= it, and drops duplicates.

Divergences: fingerprints are int64 holding uint32 values (``ops/fingerprint.py``);
``get_random`` takes its slot from a draw source (``EliteArchive.take``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from constraint_solver_tpu_torch.ops.lex import first_true, lex_argmax, lex_argmin, lex_leq
from constraint_solver_tpu_torch.utils.tree import lane_where, tree_leaves, tree_map, tree_take


class TabuRing(NamedTuple):
    fps: torch.Tensor     # int64[P, T, 2] fingerprints
    iters: torch.Tensor   # int32[P, T] engine iteration when each entry was added
    head: torch.Tensor    # int32[P] next write slot
    count: torch.Tensor   # int32[P] engine iteration counter
    expiry: torch.Tensor  # int32[P] age horizon

    @staticmethod
    def create(population: int, capacity: int, expiry: int, device) -> "TabuRing":
        i32 = dict(dtype=torch.int32, device=device)
        return TabuRing(
            fps=torch.zeros((population, capacity, 2), dtype=torch.int64, device=device),
            iters=torch.full((population, capacity), -(2**31 - 1), **i32),
            head=torch.zeros((population,), **i32),
            count=torch.zeros((population,), **i32),
            expiry=torch.full((population,), expiry, **i32),
        )

    def push(self, fp: torch.Tensor) -> "TabuRing":
        """Record each lane's visited solution ``fp`` [P, 2]."""
        capacity = self.fps.shape[1]
        count = self.count + 1
        match = (self.fps == fp[:, None, :]).all(dim=-1)
        present = match.any(dim=-1)
        slot = torch.where(present, first_true(match), self.head.long())
        sel = torch.arange(capacity, device=fp.device) == slot[:, None]
        return self._replace(
            fps=torch.where(sel[..., None], fp[:, None, :], self.fps),
            iters=torch.where(sel, count[:, None], self.iters),
            head=torch.where(present, self.head, (self.head + 1) % capacity),
            count=count,
        )

    def is_tabu(self, fps: torch.Tensor) -> torch.Tensor:
        """Membership of fps [P, W, 2] → bool[P, W]."""
        match = (fps[:, :, None, :] == self.fps[:, None, :, :]).all(dim=-1)  # [P, W, T]
        alive = self.iters + self.expiry[:, None] >= self.count[:, None]    # [P, T]
        return (match & alive[:, None, :]).any(dim=-1)


class EliteArchive(NamedTuple):
    scores: torch.Tensor  # float32[P, K, 2]
    fps: torch.Tensor     # int64[P, K, 2]
    states: Any           # state tree, [P, K, ...] leaves
    valid: torch.Tensor   # bool[P, K]

    @staticmethod
    def create(capacity: int, example_state: Any) -> "EliteArchive":
        """Empty archives shaped after ``example_state`` ([P, ...] leaves)."""
        states = tree_map(
            lambda x: torch.zeros((x.shape[0], capacity) + x.shape[1:], dtype=x.dtype, device=x.device),
            example_state,
        )
        lead = tree_leaves(example_state)[0]
        p, device = lead.shape[0], lead.device
        return EliteArchive(
            scores=torch.full((p, capacity, 2), torch.inf, device=device),
            fps=torch.zeros((p, capacity, 2), dtype=torch.int64, device=device),
            states=states,
            valid=torch.zeros((p, capacity), dtype=torch.bool, device=device),
        )

    def insert(self, score: torch.Tensor, fp: torch.Tensor, state: Any) -> "EliteArchive":
        """Insert each lane's (score [P, 2], fp [P, 2], state [P, ...])."""
        p, k = self.valid.shape
        lane = torch.arange(p, device=score.device)
        dup = self.contains_fp(fp)
        full = self.valid.sum(dim=-1) >= k
        worst = lex_argmax(self.scores, self.valid)
        slot = torch.where(full, worst, first_true(~self.valid))
        do_insert = ~dup & (~full | lex_leq(score, self.scores[lane, worst]))

        def write(arr, val):
            out = arr.clone()
            out[lane, slot] = lane_where(do_insert, val.to(arr.dtype).expand_as(arr[lane, slot]), arr[lane, slot])
            return out

        return EliteArchive(
            scores=write(self.scores, score),
            fps=write(self.fps, fp),
            states=tree_map(write, self.states, state),
            valid=write(self.valid, torch.ones_like(do_insert)),
        )

    def take(self, idx: torch.Tensor):
        """(score [P, 2], fp [P, 2], state) at slot ``idx[p]`` of each lane."""
        return tree_take((self.scores, self.fps, self.states), idx)

    def get_best(self):
        """(score [P, 2], fp [P, 2], state) of each lane's best entry."""
        return self.take(lex_argmin(self.scores, self.valid))

    def get_best_multiple(self, k: int):
        """Each lane's best ``min(k, capacity)`` entries, ascending, ties in
        slot order: (scores [P, k, 2], fps [P, k, 2], states [P, k, ...],
        valid [P, k]).  Invalid slots sort last with score +inf, and ``valid``
        marks the real entries."""
        p, cap = self.valid.shape
        k = min(k, cap)
        masked = torch.where(self.valid[..., None], self.scores, torch.inf)
        by_soft = torch.sort(masked[..., 1], dim=-1, stable=True).indices
        by_hard = torch.sort(masked[..., 0].gather(1, by_soft), dim=-1, stable=True).indices
        idx = by_soft.gather(1, by_hard)[:, :k]
        lane = torch.arange(p, device=idx.device)[:, None]
        return tree_map(lambda x: x[lane, idx], (masked, self.fps, self.states, self.valid))

    def contains_fp(self, fp: torch.Tensor) -> torch.Tensor:
        """Membership of each lane's fp [P, 2] → bool[P]."""
        return ((self.fps == fp[:, None, :]).all(dim=-1) & self.valid).any(dim=-1)
