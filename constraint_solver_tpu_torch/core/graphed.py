"""The descent iteration replayed as CUDA graphs (the port's own; the JAX package
compiles its whole ``while_loop`` instead).

On the card a descent iteration of the eager loop (``core/local_search.py``)
issues some 230 to 1,700 kernel launches from Python, by domain, and reads the
host at most once (pick-then-check's ``need.any()``), so the host's launch
rate, not the device, sets its time.  Here an iteration replays as two or
three graphs, split at that read:

- **A** (``_begin``): ``is_best``, the neighborhood (its draws and every op of
  the proposer, its hand-written kernel included), the tabu push and the first
  pick (the push and the ring's check one kernel, ``TabuRing.push_probe``) and,
  with pick-then-check, the ``need`` mask with its ``any``;
- the host reads ``need_any``; while it is set, **R** (``_retry``) replays, at
  most ``tabu_retries - 1`` times, writing its pick and mask over A's;
- **B** (``_finish``): the move and the carry's selects, then the select by the
  lanes still running, written in place into the static carry (a problem with
  ``in_place`` has its move written there under the lane mask, and its state is
  not selected again; with ``saves_best`` neither is its best key, which the
  move writes too).

Under the exact filter nothing is read, and B follows A at once.  The host
checks whether any lane still runs every ``_DONE_CHECK_EVERY`` iterations, as
the eager loop does.  The trajectory is the eager loop's bit for bit: the same
functions issue the same kernels on the same values, and each graph registers
the draw source's generator, whose Philox offset a replay advances exactly as
the eager draws would, and a capture does not.

``DescentGraphs`` belongs to one solver (``Solver``, ``PopulationSolver``),
which passes it down through ``ils_round`` to ``ls_execute``.  It holds one
``GraphedDescent`` per (problem, parameters, draw source, carry shapes), made at
first use and kept across rounds and chunks; a unit's graphs share one private
memory pool, freed with the solver.  ``eager_reason`` is the rule: a CUDA
device, a ``capturable`` problem (``core/problem.py``), no active mesh (its
collectives cannot be captured), no ``roofline`` count (a replay issues no aten
op for it to count), and a draw source whose generator lives on the card
(``graph_generator``).  Every other descent runs the eager loop.  A capture or
a replay that fails raises: nothing falls back to the eager loop.

Every problem that declares itself ``capturable`` (N-Queens and QAP without
``nbr_axis``, scheduling with every proposer, Ackley, the diagram layout)
takes this path; one unit serves whatever its problem's state tree holds (QAP
incremental carries G and H, [P, n, n] each, and its best as its permutation;
N-Queens its counters, and its best as its board),
and the phased solver, which switches problem at a round, makes one unit per
phase.

A unit runs its first iteration eagerly, on its static carry (that loads every
kernel and fills every per-device cache, such as the N-Queens log table, the
scheduling tables, QAP's F and D and the diagram's constants, before any
capture), captures A and B at its second iteration, and R at its first retry
after that; each capture is replayed at once.  Each descent copies its
start carry into the static carry and returns copies of the results, so the next
descent, or a checkpoint's ``load``, never meets stale buffers.  Captures run on
a side stream in ``thread_local`` error mode, so the service's other handler
threads may launch work meanwhile; the side stream is ordered after the
current stream's queued replays, and before its next work (``capture``).  The
launch counters of the hand-written kernels (``ops/launch_count.py``: N-Queens'
B1, K3 and K4, QAP's row minimum, the fingerprint kernels) count nothing at a
capture and what it captured at each replay, so they equal the eager run's.
A neighborhood handed over as a row block (``core/problem.py``, N-Queens) is
part of A's output like any other: A's K3 launch writes the first pick, each
replay of R reads the block A left and launches K3 with the exclusion list,
and R still copies only the pick's leaves over A's.  A replayed iteration runs no
``neighborhood``; it calls ``neighborhood(None, None, None, None)`` once, so
that whatever wraps the problem's ``neighborhood`` counts iterations as in the
eager loop.

Parallel min-conflicts (``models/nqueens_parallel.py``) is the second user of
``capture``, ``cuda_capturer`` and ``eager_reason``: its step loop bypasses
``ls_execute``, and ``PMCGraphs`` replays one step as one graph on a static
``PMCState``, under the same rule with no problem to ask.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Any, Callable, NamedTuple

import torch

from constraint_solver_tpu_torch.core.local_search import (
    _DONE_CHECK_EVERY,
    LsParams,
    _begin,
    _finish,
    _LsCarry,
    _retry,
    _retry_loop,
    _selected,
)
from constraint_solver_tpu_torch.core.problem import Problem
from constraint_solver_tpu_torch.ops import launch_count
from constraint_solver_tpu_torch.parallel.mesh import current_mesh
from constraint_solver_tpu_torch.utils import roofline
from constraint_solver_tpu_torch.utils.tree import tree_leaves, tree_map


def eager_reason(problem: Problem | None, draws, device: torch.device) -> str | None:
    """Why descents of ``problem`` on ``device`` run eagerly, or None when they
    replay as CUDA graphs.  PMC's step loop, which has no ``Problem``, passes
    None and is held to the rest of the rule."""
    if device.type != "cuda":
        return f"CUDA graphs need a CUDA device, not {device}"
    if problem is not None and not problem.capturable:
        return f"{problem.name} is not capturable"
    if current_mesh() is not None:
        return "a mesh is active: its collectives cannot be captured"
    if roofline.active_count() is not None:
        return "a roofline count is active: a replay issues no aten op for it to count"
    if getattr(draws, "graph_generator", lambda: None)() is None:
        return "the draw source has no generator on the card"
    return None


class Captured(NamedTuple):
    """One captured segment: the graph, the tensors its capture left (each
    replay rewrites them), and its launches of hand-written kernels per
    replay, per (wrapper, shape)."""

    graph: Any
    out: Any
    launches: Counter

    def replay(self) -> None:
        self.graph.replay()
        if self.launches:  # a graph without a hand-written kernel captures none
            launch_count.count_replay(self.launches)


def capture(fn: Callable, graph, stream=None, pool=None, generator=None) -> Captured:
    """Capture ``fn()`` into ``graph`` (a ``torch.cuda.CUDAGraph``) on
    ``stream`` (None: the current one, for a stand-in graph), in the memory
    ``pool``, with ``generator`` registered.  The kernels' launch counters see
    nothing of it.  Raises what the capture raises.

    ``stream`` waits for the work queued on the current stream before the
    capture, and the current stream for ``stream`` after it: ``capture_begin``
    refills the registered generator's seed and offset on the device, outside
    the graph and on the capturing stream, and that refill must land neither
    while a replay queued before it still draws (a segment captured right after
    another segment's replay, with no host read between them) nor after the
    refill of the next replay."""
    if generator is not None:
        graph.register_generator_state(generator)
    on_stream, current = contextlib.nullcontext(), None
    if stream is not None:
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        on_stream = torch.cuda.stream(stream)
    try:
        with launch_count.captured() as launches, on_stream:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):  # ending a failed capture may fail too; raise the cause
                    graph.capture_end()
                raise
            graph.capture_end()
    finally:
        if current is not None:
            current.wait_stream(stream)
    return Captured(graph, out, launches)


def cuda_capturer(device: torch.device, draws) -> Callable[[Callable], Captured]:
    """Captures into new CUDA graphs on a side stream of ``device``, all in one
    private memory pool, with the draw source's generator registered."""
    stream = torch.cuda.Stream(device)
    pool = torch.cuda.graph_pool_handle()
    generator = draws.graph_generator()
    return lambda fn: capture(fn, torch.cuda.CUDAGraph(), stream, pool, generator)


class GraphedDescent:
    """One (problem, parameters, draw source, carry shapes)'s descent iteration
    on a static carry, its segments captured by ``capture`` (see the module
    docstring).  With ``capture=None`` every segment runs eagerly on the static
    carry: the CPU tests hold that loop against the eager one."""

    def __init__(self, problem: Problem, params: LsParams, draws, c0: _LsCarry, capture=None):
        self.problem, self.params, self.draws = problem, params, draws
        self.carry = tree_map(torch.empty_like, c0)
        self._capture = capture
        self._warm = False
        self._a = self._r = self._b = None
        self.capture_s = 0.0  # host seconds spent capturing

    def descend(self, c0: _LsCarry) -> _LsCarry:
        """The eager loop of ``ls_execute`` from carry ``c0``: the final carry."""
        torch._foreach_copy_(tree_leaves(self.carry), tree_leaves(c0))
        for i in range(self.params.max_iterations):
            if i % _DONE_CHECK_EVERY == 0 and bool(self.carry.done.all()):
                break
            self._iteration()
        return tree_map(torch.clone, self.carry)

    def _seg_a(self):
        """(active, the iteration begun) on the static carry."""
        active = ~self.carry.done
        return active, _begin(self.problem, self.params, self.carry, self.draws, active)

    def _seg_r(self, a):
        """One more pick for the lanes that need it, written over ``a``'s."""
        active, b = a
        new = _retry(self.problem, self.params, self.carry, b, active)
        mine, fresh = (b.pick, b.need, b.need_any), (new.pick, new.need, new.need_any)
        for dst, src in zip(tree_leaves(mine), tree_leaves(fresh)):
            dst.copy_(src)
        return b

    def _seg_b(self, a) -> None:
        """The move and the carry's selects, written into the static carry for
        the lanes still running (a masked move has written the state there
        already, and with ``saves_best`` the best key)."""
        active, b = a
        new = _finish(self.problem, self.params, self.carry, b, active)
        mine, fresh = _selected(self.problem, self.carry), _selected(self.problem, new)
        for dst, src in zip(tree_leaves(mine), tree_leaves(fresh)):
            torch.where(active.view(active.shape + (1,) * (dst.dim() - 1)), src, dst, out=dst)

    def _captured(self, fn: Callable) -> Captured:
        t0 = time.perf_counter()
        seg = self._capture(fn)
        self.capture_s += time.perf_counter() - t0
        return seg

    def _iteration(self) -> None:
        if self._capture is None or not self._warm:
            a = self._seg_a()
            _retry_loop(self.params, a[1], lambda _: self._seg_r(a))
            self._seg_b(a)
            self._warm = True
            return
        if self._a is None:
            self._a = self._captured(self._seg_a)  # its capture made this iteration's neighborhood call
        else:
            self.problem.neighborhood(None, None, None, None)
        self._a.replay()
        a = self._a.out

        def retry(_):
            if self._r is None:
                self._r = self._captured(lambda: self._seg_r(a))
            self._r.replay()
            return a[1]

        _retry_loop(self.params, a[1], retry)
        if self._b is None:
            self._b = self._captured(lambda: self._seg_b(a))
        self._b.replay()


class DescentGraphs:
    """A solver's graphed descents: one ``GraphedDescent`` per (problem,
    parameters, draw source, carry shapes), made at first use.  ``capturer``
    makes a unit's capture function from (device, draws); None runs the units'
    segments eagerly (the CPU tests)."""

    def __init__(self, capturer: Callable | None = cuda_capturer):
        self._capturer = capturer
        self._units: dict = {}

    def applies(self, problem: Problem, draws, device: torch.device) -> bool:
        return eager_reason(problem, draws, device) is None

    def descend(self, problem: Problem, params: LsParams, c0: _LsCarry, draws) -> _LsCarry:
        key = (problem, params, draws, tuple((x.shape, x.dtype, x.device) for x in tree_leaves(c0)))
        unit = self._units.get(key)
        if unit is None:
            capture = self._capturer(c0.done.device, draws) if self._capturer is not None else None
            unit = self._units[key] = GraphedDescent(problem, params, draws, c0, capture)
        return unit.descend(c0)

    @property
    def capture_s(self) -> float:
        """Host seconds spent capturing, over every unit."""
        return sum(unit.capture_s for unit in self._units.values())
