"""Checkpoint and resume (port of ``constraint_solver_tpu/utils/checkpoint.py``).

A checkpoint is the exact solver state in one ``.npz`` file: every leaf of the
lane-batched state tree (solutions, elite archives, tabu rings, counters), a
JSON header (format version, the solver's metadata, the host round counter) and
the draw source's ``state_dict``.  Resume is bit-exact: a resumed run continues
the same trajectory as one that never stopped.  Writes are atomic (a temporary
file, then ``os.replace``), so a crash mid-save keeps the previous checkpoint.

Divergences from the JAX package:

- **The format differs.** The JAX state carries its PRNG keys as leaves; the
  port's state has no key, and the file holds the draw source's state (for
  ``TorchDraws``, the ``torch.Generator`` state) and the host round counter
  instead.  The two packages cannot read each other's checkpoints.
- **Sharded solvers** gather every rank's lanes before ``save_state`` and
  write from rank 0 alone, as the JAX package gathers its globally sharded
  leaves to process 0 (``PopulationSolver.save``); ``load_into`` reads the
  whole file on every rank and keeps the rank's share (``shard``).  The file
  is the one-device layout either way.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from constraint_solver_tpu_torch.parallel.mesh import world_any
from constraint_solver_tpu_torch.utils.tree import tree_leaves, tree_map

_FORMAT_VERSION = 1
_DRAWS_PREFIX = "draws."


class Checkpoint(NamedTuple):
    state: Any   # the state tree, on the example's devices
    meta: dict   # the solver's metadata (problem, seed, population, ...)
    draws: dict  # the draw source's state_dict, numpy arrays
    round: int   # the host round counter


def checkpoint_path(path: str) -> str:
    """The on-disk path for ``path`` (``np.savez`` appends '.npz' to bare
    paths; every save, load and existence check uses this form)."""
    return path if path.endswith(".npz") else path + ".npz"


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(checkpoint_path(path))


def resume_and_run(solver, checkpoint: str | None, every: int, **run_kwargs):
    """Load ``checkpoint`` if it exists (announcing the resumed round), then
    run with a snapshot every ``every`` rounds.  Works for ``Solver``,
    ``PopulationSolver`` and ``PhasedPopulationSolver``."""
    if checkpoint and checkpoint_exists(checkpoint):
        solver.load(checkpoint)
        print(f"resumed from {checkpoint} at round {solver.get_iteration_info()['current']}")
    solver.run(checkpoint_path=checkpoint, checkpoint_every=every, **run_kwargs)


def save_state(path: str, state: Any, meta: dict, draws, round_no: int) -> None:
    """Write ``state`` (any state tree), ``meta``, ``draws.state_dict()`` and
    the host round counter ``round_no`` to ``path`` (.npz), atomically."""
    leaves = tree_leaves(state)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(leaves)}
    for name, value in draws.state_dict().items():
        arrays[_DRAWS_PREFIX + name] = np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value)
    header = json.dumps({"version": _FORMAT_VERSION, "num_leaves": len(leaves), "round": round_no, "meta": meta})
    arrays["__header__"] = np.frombuffer(header.encode(), dtype=np.uint8)
    final = checkpoint_path(path)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(os.path.abspath(final)))
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str, example: Any) -> Checkpoint:
    """Read a checkpoint; ``example`` (a state built with the same problem and
    configuration) gives the tree structure and each leaf's device."""
    with np.load(checkpoint_path(path)) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        if header["version"] != _FORMAT_VERSION:
            raise ValueError(f"checkpoint format {header['version']}, expected {_FORMAT_VERSION}")
        n = len(tree_leaves(example))
        if header["num_leaves"] != n:
            raise ValueError(f"checkpoint has {header['num_leaves']} state leaves, the solver's state has {n}")
        leaves = iter([data[f"leaf_{i}"] for i in range(n)])
        state = tree_map(lambda x: torch.from_numpy(next(leaves)).to(x.device), example)
        draws = {k[len(_DRAWS_PREFIX):]: data[k] for k in data.files if k.startswith(_DRAWS_PREFIX)}
    return Checkpoint(state, header["meta"], draws, int(header["round"]))


def load_into(solver, path: str, population: int, shard=None) -> dict:
    """Resume ``solver`` (a ``Solver`` or ``PopulationSolver``) from a
    checkpoint of the same problem with ``population`` lanes (1 for the
    single-trajectory ``Solver``): its state, draw-source state and round
    counter; ``shard`` maps the whole state to the solver's share of it.
    Returns the checkpoint's metadata.  Raises ``ValueError`` for another
    problem, another population, or lanes out of lockstep (every lane's
    ``round`` must equal the host round: a hand-merged state would restart
    lanes on wrong rounds)."""
    ckpt = load_state(path, solver.state)
    meta = ckpt.meta
    if meta.get("problem") != solver.problem.name:
        raise ValueError(f"checkpoint is for {meta.get('problem')}, solver is {solver.problem.name}")
    got = meta.get("population", 1)
    if got != population:
        if population == 1:
            raise ValueError(f"checkpoint is population-mode (P={got}); resume it with the same --population")
        raise ValueError(f"checkpoint is for population={got}, solver has population={population}")
    rounds = torch.unique(ckpt.state.round).tolist()
    if rounds != [ckpt.round]:
        raise ValueError(
            f"checkpoint violates the lane-lockstep round invariant (rounds {rounds}, host round {ckpt.round})"
        )
    solver.state = shard(ckpt.state) if shard is not None else ckpt.state
    solver.draws.load_state_dict(ckpt.draws)
    solver._round = ckpt.round
    return meta


def run_chunks(solver, total: int, advance, best, is_best, report=None, path: str | None = None, every: int = 200):
    """The round loop of every solver's ``run``.  Until ``solver._round``
    reaches ``total``, ``solver.cancel()`` is called or ``is_best(score)``
    holds: ``advance(total)`` runs one chunk (never past ``total``), the host
    reads ``score = best()`` once, and ``report(score)`` prints it when given
    (``verbose``).  With ``path``, ``solver.save(path)`` runs every ``every``
    rounds and at the end.  The loop's wall time adds to ``solver._wall``.
    Under an active mesh the cancel is read over the whole world
    (``world_any``), so every rank leaves the loop at the same chunk."""
    last_ckpt = solver._round
    t0 = time.time()
    while solver._round < total and not world_any(torch.tensor([solver.cancelled])):
        advance(total)
        score = best()
        if report is not None:
            report(score)
        if path and solver._round - last_ckpt >= every:
            solver.save(path)
            last_ckpt = solver._round
        if is_best(score):
            break
    solver._wall += time.time() - t0
    if path:
        solver.save(path)
