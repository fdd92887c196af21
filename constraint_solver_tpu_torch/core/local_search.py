"""Inner local-search descent, batched over lanes
(port of ``constraint_solver_tpu/core/local_search.py``).

The semantics are the JAX package's: push the current solution into the tabu
ring, stop at ``is_best``, score the neighborhood, take its best non-tabu
candidate even when it is worse, advance the best only on strict improvement,
and bail after ``allow_no_improvement_for`` non-improving iterations or on an
empty neighborhood.  Tabu is resolved either by pick-then-check with a bounded
retry budget (wide neighborhoods) or by the reference's exact filter.

The JAX package ``vmap``s a ``lax.while_loop``: a lane that is done keeps its whole
carry while the others go on.  Here that is written out: one Python loop over all
lanes, each iteration's results selected per lane by the mask of lanes still
running, and the host asks whether any lane is still running only every
``_DONE_CHECK_EVERY`` iterations (an iteration with no lane running changes
nothing).  The retry loop of pick-then-check is masked the same way and ends when
no lane needs another retry.

Noisy selection (``select_topk > 1``) samples the applied move from the top-k
non-tabu candidates (``ops/lex.noisy_lex_select``), on the exact-filter path
only, as in the JAX package.

Divergences: randomness comes from a ``Draws`` source (the noisy selection's
Gumbel noise from ``draws.select_noise``, in the iteration's neighborhood
draws), and ``fixed_trip`` is not needed: every loop here already has the
masked form it asks for.  Under a mesh (``parallel/mesh.py``) the done check is
world-agreed (``world_any``), the port's form of ``fixed_trip``: every rank runs
the same number of iterations, so the neighborhood's collectives and draws stay
matched.  The retry loop of pick-then-check needs no agreement: it draws
nothing, and the problems that shard a neighborhood hand the engine moves that
``move_fp`` resolves without a collective.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from constraint_solver_tpu_torch.core.history import TabuRing
from constraint_solver_tpu_torch.core.problem import Problem
from constraint_solver_tpu_torch.ops.lex import lex_argmin, lex_less, noisy_lex_select
from constraint_solver_tpu_torch.parallel.mesh import world_any
from constraint_solver_tpu_torch.utils.tree import lane_where, tree_where

_DONE_CHECK_EVERY = 8


class LsParams(NamedTuple):
    """The JAX package's descent knobs (see its ``LsParams``)."""

    max_iterations: int
    allow_no_improvement_for: int
    tabu_retries: int = 8
    tabu_exact_filter: bool = False
    tabu_forced: bool = False
    select_topk: int = 0
    select_temp: float = 1.0


class _LsCarry(NamedTuple):
    state: Any
    score: torch.Tensor       # float32[P, 2]
    fp: torch.Tensor          # int64[P, 2]
    best_state: Any
    best_score: torch.Tensor  # float32[P, 2]
    tabu: TabuRing
    no_improve: torch.Tensor  # int32[P]
    it: torch.Tensor          # int32[P]
    done: torch.Tensor        # bool[P]
    exhausted: torch.Tensor   # int32[P]


class _Pick(NamedTuple):
    idx: torch.Tensor    # int64[P]
    fp: torch.Tensor     # int64[P, 2]
    found: torch.Tensor  # bool[P]
    tries: torch.Tensor  # int64[P]
    excl: torch.Tensor   # int64[P, retries] examined candidates, -1 = empty


def _pick_then_check(problem, params, nb, tabu, c, n_valid, active):
    """Take each lane's best candidate, fingerprint it, and re-pick among the
    unexamined ones while it is tabu, examining at most ``tabu_retries``.
    Returns (idx, cand_fp, found, exhausted_event)."""
    retries = params.tabu_retries
    p = n_valid.shape[0]
    lane = torch.arange(p, device=n_valid.device)
    idx0 = nb.hint_idx if nb.hint_idx is not None else lex_argmin(nb.scores, nb.valid)
    fp0 = problem.move_fp(c.state, c.fp, nb.moves, idx0)
    found0 = ~tabu.is_tabu(fp0[:, None, :])[:, 0] & (n_valid > 0)
    excl = torch.full((p, retries), -1, dtype=torch.int64, device=n_valid.device)
    excl[:, 0] = idx0
    pick = _Pick(idx0, fp0, found0, torch.ones_like(idx0), excl)
    iota_w = torch.arange(nb.valid.shape[1], device=n_valid.device)

    for _ in range(retries - 1):
        need = active & ~pick.found & (pick.tries < retries) & (pick.tries < n_valid)
        if not bool(need.any()):
            break
        mask = nb.valid
        for k in range(retries):  # -1 slots never match
            mask = mask & (iota_w != pick.excl[:, k : k + 1])
        idx = lex_argmin(nb.scores, mask)
        fp = problem.move_fp(c.state, c.fp, nb.moves, idx)
        hit = tabu.is_tabu(fp[:, None, :])[:, 0]
        excl = pick.excl.clone()
        excl[lane, pick.tries.clamp_max(retries - 1)] = idx
        pick = tree_where(need, _Pick(idx, fp, ~hit, pick.tries + 1, excl), pick)
    exhausted_event = ~pick.found & (n_valid > pick.tries)
    return pick.idx, pick.fp, pick.found, exhausted_event


def _step(problem: Problem, params: LsParams, c: _LsCarry, draws, active) -> _LsCarry:
    """One descent iteration for every lane (the JAX ``body``)."""
    tabu = c.tabu.push(c.fp)
    hit_best = problem.is_best(c.score)
    nb = problem.neighborhood(c.state, c.score, draws, active)
    n_valid = nb.n_valid if nb.n_valid is not None else nb.valid.sum(dim=-1)
    lane = torch.arange(n_valid.shape[0], device=n_valid.device)

    use_exact = (
        params.tabu_exact_filter
        if params.tabu_forced
        else params.tabu_exact_filter or nb.fp_deltas is not None
    )
    if use_exact:
        if nb.fp_deltas is not None:
            fps_all = c.fp[:, None, :] ^ nb.fp_deltas
        else:
            iota_w = torch.arange(nb.valid.shape[1], device=n_valid.device)
            fps_all = problem.move_fp(c.state, c.fp, nb.moves, iota_w.expand(nb.valid.shape))
        ok = nb.valid & ~tabu.is_tabu(fps_all)
        found = ok.any(dim=-1)
        if params.select_topk > 1:
            noise = draws.select_noise(ok.shape[1], active)
            idx = noisy_lex_select(nb.scores, ok, params.select_topk, params.select_temp, noise)
        else:
            idx = lex_argmin(nb.scores, ok)
        cand_fp = fps_all[lane, idx]
        exhausted_event = torch.zeros_like(found)
        empty_nbr = ~found
    else:
        idx, cand_fp, found, exhausted_event = _pick_then_check(
            problem, params, nb, tabu, c, n_valid, active
        )
        empty_nbr = n_valid == 0

    cand_score = nb.scores[lane, idx]
    cand_state = problem.apply_move(c.state, nb.moves, idx)
    improved = lex_less(cand_score, c.score) & found
    step = found & ~hit_best
    no_improve = torch.where(improved, 0, c.no_improve + 1).to(torch.int32)
    bail = ~improved & (no_improve >= params.allow_no_improvement_for)
    new_best = improved | hit_best

    return _LsCarry(
        state=tree_where(step, cand_state, c.state),
        score=lane_where(step, cand_score, c.score),
        fp=lane_where(step, cand_fp, c.fp),
        best_state=tree_where(new_best, tree_where(hit_best, c.state, cand_state), c.best_state),
        best_score=lane_where(new_best, lane_where(hit_best, c.score, cand_score), c.best_score),
        tabu=tabu,
        no_improve=torch.where(step | ~found, no_improve, c.no_improve),
        it=c.it + 1,
        done=hit_best | bail | empty_nbr,
        exhausted=c.exhausted + exhausted_event.to(torch.int32),
    )


def ls_execute(problem: Problem, params: LsParams, start_state, tabu: TabuRing, draws, enabled):
    """Run one descent per lane from ``start_state``; lanes with
    ``enabled[p]`` False do nothing.  Returns ``(best_state, best_score, tabu,
    iterations_used [P], exhausted [P])``."""
    start_score = problem.score(start_state)
    zeros = torch.zeros_like(enabled, dtype=torch.int32)
    c = _LsCarry(
        state=start_state,
        score=start_score,
        fp=problem.fingerprint(start_state),
        best_state=start_state,
        best_score=start_score,
        tabu=tabu,
        no_improve=zeros,
        it=zeros,
        done=~enabled,
        exhausted=zeros,
    )
    for i in range(params.max_iterations):
        active = ~c.done
        if i % _DONE_CHECK_EVERY == 0 and not world_any(active):
            break
        c = tree_where(active, _step(problem, params, c, draws, active), c)
    return c.best_state, c.best_score, c.tabu, c.it, c.exhausted
