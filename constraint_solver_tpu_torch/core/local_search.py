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

An iteration is three functions: ``_begin`` (the neighborhood, the push and
the first pick), ``_retry`` (one more pick-then-check pick, while the host's read
of ``need_any`` says some lane needs it) and ``_finish`` (the move and the
carry).  On the card ``core/graphed.py`` replays each of them as a CUDA graph.
The neighborhood is read through its accessors (``core/problem.py``): for a
row block (N-Queens) each pick of pick-then-check is one K3 launch
(``Neighborhood.pick``) and the pick's score is read from the hard block, so
the [P, W, 2] score block and its [P, W] mask are built only on the exact-filter
path, which reads every candidate.

Noisy selection (``select_topk > 1``) samples the applied move from the top-k
non-tabu candidates (``ops/lex.noisy_lex_select``), on the exact-filter path
only, as in the JAX package.

Divergences: randomness comes from a ``Draws`` source (the noisy selection's
Gumbel noise from ``draws.select_noise``, in the iteration's neighborhood
draws), and ``fixed_trip`` is not needed: every loop here already has the
masked form it asks for.  The JAX package selects the whole state tree per lane
twice an iteration (the step's and the best's), and again by the lanes still
running; XLA fuses those selects into the move.  Here each would be a pass of
its own over the state, so a problem with ``in_place`` (QAP's incremental G
and H, ``models/qap.py``; N-Queens without ``nbr_axis``, ``models/nqueens.py``,
whose move is K4) has its move written in place into the carry's own
state, under the mask of lanes that step and still run, and its state is not
selected again; the descent carries its best as its key (QAP's permutation,
the N-Queens board) and ``ls_execute`` rebuilds the best state from it once,
at the end.  With ``InPlace.saves_best`` (N-Queens) the move also writes the
key into the carried best, in the lanes that reach a new best and still
run, so the best is not selected either.  The answers are the same bit for
bit: the other lanes' state is left untouched, and the rebuilt state is the
one the key stands for.

Under a mesh (``parallel/mesh.py``) the done check is world-agreed
(``world_any``), the port's form of ``fixed_trip``: every rank runs the same
number of iterations, so the neighborhood's collectives and draws stay matched.
The retry loop of pick-then-check needs no agreement: it draws nothing, and the
problems that shard a neighborhood hand the engine moves that ``move_fp``
resolves without a collective.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from constraint_solver_tpu_torch.core.history import TabuRing
from constraint_solver_tpu_torch.core.problem import Problem
from constraint_solver_tpu_torch.ops.lex import lex_argmin, lex_less, noisy_lex_select
from constraint_solver_tpu_torch.parallel.mesh import world_any
from constraint_solver_tpu_torch.utils.tree import lane_where, tree_map, tree_where

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
    tries: torch.Tensor | None  # int64[P] candidates examined (pick-then-check)
    excl: torch.Tensor | None   # int64[P, retries] examined candidates, -1 = empty (pick-then-check)


class _Begun(NamedTuple):
    """An iteration up to its first pick: what ``_retry`` and ``_finish`` read."""

    tabu: TabuRing            # the ring after this iteration's push
    hit_best: torch.Tensor    # bool[P]
    nb: Any                   # the Neighborhood
    n_valid: torch.Tensor     # int64[P]
    pick: _Pick               # the pick so far; under the exact filter the final one
    need: torch.Tensor | None      # bool[P] lanes that pick again (pick-then-check), else None
    need_any: torch.Tensor | None  # need.any(): the one value of the iteration the host reads


def _need(params, pick: _Pick, n_valid, active):
    need = active & ~pick.found & (pick.tries < params.tabu_retries) & (pick.tries < n_valid)
    return need, need.any()


def _begin(problem: Problem, params: LsParams, c: _LsCarry, draws, active) -> _Begun:
    """The early-exit test, the neighborhood, the push and the first pick: under
    the exact filter the best non-tabu candidate; with pick-then-check each
    lane's best candidate, fingerprinted and checked against the ring.  The push
    and the check are one ``push_probe`` (one launch on the card); the
    neighborhood reads no ring, so pushing after it changes nothing."""
    hit_best = problem.is_best(c.score)
    nb = problem.neighborhood(c.state, c.score, draws, active)
    n_valid = nb.n_valid if nb.n_valid is not None else nb.all_valid().sum(dim=-1)
    use_exact = (
        params.tabu_exact_filter
        if params.tabu_forced
        else params.tabu_exact_filter or nb.fp_deltas is not None
    )
    if use_exact:
        # Every candidate is read here, as in the JAX package: a row block is built whole.
        lane = torch.arange(n_valid.shape[0], device=n_valid.device)
        scores, valid = nb.all_scores(), nb.all_valid()
        if nb.fp_deltas is not None:
            tabu, ok = c.tabu.push_probe(c.fp, base=c.fp, deltas=nb.fp_deltas, valid=valid)
        else:
            iota_w = torch.arange(valid.shape[1], device=n_valid.device)
            fps_all = problem.move_fp(c.state, c.fp, nb.moves, iota_w.expand(valid.shape))
            tabu, ok = c.tabu.push_probe(c.fp, fps=fps_all, valid=valid)
        found = ok.any(dim=-1)
        if params.select_topk > 1:
            noise = draws.select_noise(ok.shape[1], active)
            idx = noisy_lex_select(scores, ok, params.select_topk, params.select_temp, noise)
        else:
            idx = lex_argmin(scores, ok)
        fp = c.fp ^ nb.fp_deltas[lane, idx] if nb.fp_deltas is not None else fps_all[lane, idx]
        pick = _Pick(idx, fp, found, None, None)
        return _Begun(tabu, hit_best, nb, n_valid, pick, None, None)
    idx0 = nb.hint_idx if nb.hint_idx is not None else nb.pick()
    fp0 = problem.move_fp(c.state, c.fp, nb.moves, idx0)
    tabu, found0 = c.tabu.push_probe(c.fp, fps=fp0[:, None, :], valid=(n_valid > 0)[:, None])
    found0 = found0[:, 0]
    excl = torch.full((n_valid.shape[0], params.tabu_retries), -1, dtype=torch.int64, device=n_valid.device)
    excl[:, 0] = idx0
    pick = _Pick(idx0, fp0, found0, torch.ones_like(idx0), excl)
    need, need_any = _need(params, pick, n_valid, active)
    return _Begun(tabu, hit_best, nb, n_valid, pick, need, need_any)


def _retry(problem: Problem, params: LsParams, c: _LsCarry, b: _Begun, active) -> _Begun:
    """One more pick-then-check pick for the lanes in ``b.need``: their best
    candidate among the unexamined ones (``Neighborhood.pick``: for a row block
    one K3 launch, no mask pass), fingerprinted and checked."""
    retries, nb, pick = params.tabu_retries, b.nb, b.pick
    lane = torch.arange(b.n_valid.shape[0], device=b.n_valid.device)
    idx = nb.pick(pick.excl)
    fp = problem.move_fp(c.state, c.fp, nb.moves, idx)
    # ``valid`` is ``need``: the lanes that take this pick get ``~tabu``, the others keep theirs.
    _, found = b.tabu.push_probe(fps=fp[:, None, :], valid=b.need[:, None])
    excl = pick.excl.clone()
    excl[lane, pick.tries.clamp_max(retries - 1)] = idx
    pick = tree_where(b.need, _Pick(idx, fp, found[:, 0], pick.tries + 1, excl), pick)
    need, need_any = _need(params, pick, b.n_valid, active)
    return b._replace(pick=pick, need=need, need_any=need_any)


def _retry_loop(params: LsParams, b: _Begun, retry) -> _Begun:
    """Pick-then-check's loop: ``retry(b)`` while some lane needs another pick,
    at most ``tabu_retries - 1`` times; the host reads ``need_any`` before each."""
    if b.need is None:
        return b
    for _ in range(params.tabu_retries - 1):
        if not bool(b.need_any):
            break
        b = retry(b)
    return b


def _finish(problem: Problem, params: LsParams, c: _LsCarry, b: _Begun, active) -> _LsCarry:
    """Apply each lane's pick and advance its carry (before the select by the
    lanes still running, ``_keep_running``).  With ``in_place`` the move is
    written into ``c.state`` itself, in the lanes that step and still run, and
    the best is carried as its key; with ``saves_best`` the move writes that
    key into ``c.best_state`` too, in the lanes that reach a new best and
    still run."""
    nb, pick, hit_best = b.nb, b.pick, b.hit_best
    if b.need is None:
        exhausted_event, empty_nbr = torch.zeros_like(pick.found), ~pick.found
    else:
        exhausted_event, empty_nbr = ~pick.found & (b.n_valid > pick.tries), b.n_valid == 0
    cand_score = nb.score_at(pick.idx)
    improved = lex_less(cand_score, c.score) & pick.found
    step = pick.found & ~hit_best
    no_improve = torch.where(improved, 0, c.no_improve + 1).to(torch.int32)
    bail = ~improved & (no_improve >= params.allow_no_improvement_for)
    new_best = improved | hit_best

    ip = problem.in_place
    if ip is None:
        cand_state = problem.apply_move(c.state, nb.moves, pick.idx)
        state = tree_where(step, cand_state, c.state)
        best_state = tree_where(new_best, tree_where(hit_best, c.state, cand_state), c.best_state)
    elif ip.saves_best:
        # A hit lane does not step, so its moved state is its old one; a lane
        # that improves without a hit steps.  An inactive lane is not written.
        ip.move(c.state, nb.moves, pick.idx, step & active, best=c.best_state, save=new_best & active)
        state, best_state = c.state, c.best_state
    else:
        # A hit lane's new best is its old state: take its key before the
        # move writes over the old state.  A lane that takes the moved state
        # steps, so its state is the moved one after the call.
        kept = tree_where(hit_best, ip.key(c.state), c.best_state)
        ip.move(c.state, nb.moves, pick.idx, step & active)
        state = c.state
        best_state = tree_where(new_best & ~hit_best, ip.key(state), kept)

    return _LsCarry(
        state=state,
        score=lane_where(step, cand_score, c.score),
        fp=lane_where(step, pick.fp, c.fp),
        best_state=best_state,
        best_score=lane_where(new_best, lane_where(hit_best, c.score, cand_score), c.best_score),
        tabu=b.tabu,
        no_improve=torch.where(step | ~pick.found, no_improve, c.no_improve),
        it=c.it + 1,
        done=hit_best | bail | empty_nbr,
        exhausted=c.exhausted + exhausted_event.to(torch.int32),
    )


def _step(problem: Problem, params: LsParams, c: _LsCarry, draws, active) -> _LsCarry:
    """One descent iteration for every lane (the JAX ``body``)."""
    b = _begin(problem, params, c, draws, active)
    b = _retry_loop(params, b, lambda b: _retry(problem, params, c, b, active))
    return _finish(problem, params, c, b, active)


def _written(problem: Problem, c: _LsCarry) -> dict:
    """The fields of carry ``c`` that the move writes in place: the state with
    ``in_place``, the best key too with ``saves_best``."""
    ip = problem.in_place
    if ip is None:
        return {}
    return {"state": c.state, "best_state": c.best_state} if ip.saves_best else {"state": c.state}


def _selected(problem: Problem, c: _LsCarry) -> _LsCarry:
    """The part of carry ``c`` that the select by the lanes still running
    writes: all of it, but what the move wrote in place (``_written``)."""
    return c._replace(**dict.fromkeys(_written(problem, c), ()))


def _keep_running(problem: Problem, active, new: _LsCarry, old: _LsCarry) -> _LsCarry:
    """``new`` in the lanes still running, ``old`` in the others (with
    ``in_place``, what the move wrote is taken from ``old``: the move has
    written it there)."""
    if problem.in_place is None:
        return tree_where(active, new, old)
    kept = tree_where(active, _selected(problem, new), _selected(problem, old))
    return kept._replace(**_written(problem, old))


def ls_execute(problem: Problem, params: LsParams, start_state, tabu: TabuRing, draws, enabled, graphs=None):
    """Run one descent per lane from ``start_state``; lanes with
    ``enabled[p]`` False do nothing.  Returns ``(best_state, best_score, tabu,
    iterations_used [P], exhausted [P])``.  ``graphs`` (``core/graphed.py``'s
    ``DescentGraphs``, the solver's) replays the iterations as CUDA graphs
    where its rule allows; otherwise, and without it, they run eagerly.
    ``start_state`` is left as it was."""
    start_score = problem.score(start_state)
    zeros = torch.zeros_like(enabled, dtype=torch.int32)
    c = _LsCarry(
        state=start_state,
        score=start_score,
        fp=problem.fingerprint(start_state),
        best_state=start_state if problem.in_place is None else problem.in_place.key(start_state),
        best_score=start_score,
        tabu=tabu,
        no_improve=zeros,
        it=zeros,
        done=~enabled,
        exhausted=zeros,
    )
    if graphs is not None and graphs.applies(problem, draws, enabled.device):
        c = graphs.descend(problem, params, c, draws)  # copies c into the graphs' own carry
    else:
        # The move writes the carry's state, and with ``saves_best`` its best
        # key, which is taken from ``start_state`` itself: both become copies.
        c = c._replace(**{k: tree_map(torch.clone, v) for k, v in _written(problem, c).items()})
        for i in range(params.max_iterations):
            active = ~c.done
            if i % _DONE_CHECK_EVERY == 0 and not world_any(active):
                break
            c = _keep_running(problem, active, _step(problem, params, c, draws, active), c)
    best = c.best_state if problem.in_place is None else problem.in_place.rebuild(c.best_state)
    return best, c.best_score, c.tabu, c.it, c.exhausted
