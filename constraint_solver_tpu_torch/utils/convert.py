"""Solver state carried between the JAX package and the port.

There are no weights in this system: its "parameters" are the solver state.
``from_reference`` turns a JAX ``IlsState`` (or any tree of ``NamedTuple``s with
the same class and field names and array leaves with a leading lane axis P:
boards, counters, tabu ring, elite archive, uint32 fingerprints) into the port's
state on a given device.  ``to_reference`` turns the port's state back into the
same tree with numpy leaves in the JAX package's dtypes.  The JAX state's PRNG
``key`` has no counterpart (``utils/draws.py``) and is skipped.

Dtype map: fingerprint fields (uint32 there, int64 in [0, 2^32) here) and
solutions convert exactly; every other leaf keeps its dtype.  The rule for
solutions: N-Queens boards (``rows``), QAP permutations (``p``, bare or in a
``QAPState``), scheduling assignments and diagram positions are int32 there and
int64 here.  A scheduling, dense QAP or diagram state is a bare array, so an
integer leaf in a solution's place (``current_state``, the archive's
``states``) is a solution; a float leaf there (an Ackley point, float32 on both
sides) keeps its dtype.  PMC's ``PMCState`` crosses without its key.  A single
JAX ``Solver``'s state has no lane axis: give it one first.

``reference_share`` slices a JAX global state (numpy leaves) to one rank's
share of a sharded solver: its lanes and, for the date-sharded solver, its days
of every solution (padded with -1 past the schedule), so both sides can start
from, or be compared on, the same state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from constraint_solver_tpu_torch.core.history import EliteArchive, TabuRing
from constraint_solver_tpu_torch.core.ils import IlsState
from constraint_solver_tpu_torch.models.nqueens import NQState
from constraint_solver_tpu_torch.models.nqueens_parallel import PMCState
from constraint_solver_tpu_torch.models.qap import QAPState

_CLASSES = {cls.__name__: cls for cls in (IlsState, EliteArchive, TabuRing, NQState, PMCState, QAPState)}
_FP_FIELDS = ("fps", "current_fp")
_SOLUTION_FIELDS = ("rows", "p", "current_state", "states")


def _ref_dtype(field: str, x: torch.Tensor):
    if x.dtype != torch.int64:
        return None
    return np.uint32 if field in _FP_FIELDS else np.int32


def from_reference(ref: Any, device) -> Any:
    """The port's state tree for a JAX state tree ``ref``."""

    def conv(node, field):
        if hasattr(node, "_fields"):
            name = type(node).__name__
            if name not in _CLASSES:
                raise TypeError(f"no port class for {name}")
            cls = _CLASSES[name]
            return cls(*(conv(getattr(node, f), f) for f in cls._fields))
        a = np.asarray(node)
        if a.dtype == np.uint32 or (field in _SOLUTION_FIELDS and a.dtype == np.int32):
            a = a.astype(np.int64)
        return torch.tensor(a, device=device)

    return conv(ref, "")


def to_reference(st: Any) -> Any:
    """The port's state tree with numpy leaves in the JAX package's dtypes."""

    def conv(node, field):
        if hasattr(node, "_fields"):
            return type(node)(*(conv(getattr(node, f), f) for f in node._fields))
        a = node.detach().cpu().numpy()
        dtype = _ref_dtype(field, node)
        if dtype is not None:
            a = a.astype(dtype)
        return a

    return conv(st, "")


def reference_share(ref: Any, lanes: slice, days: tuple | None = None) -> Any:
    """The lanes ``lanes`` of a JAX state tree with numpy leaves and, with
    ``days = (start, stop, d_pad)``, days [start, stop) of every solution leaf
    (``current_state``, the archive's ``states``) after padding it with -1 to
    ``d_pad`` days, in the port's classes (the PRNG ``key`` has no field there)."""

    def conv(node, field):
        if hasattr(node, "_fields"):
            cls = _CLASSES.get(type(node).__name__, type(node))
            return cls(*(conv(getattr(node, f), f) for f in cls._fields))
        a = np.asarray(node)[lanes]
        if days is not None and field in ("current_state", "states"):
            start, stop, d_pad = days
            pad = np.full(a.shape[:-1] + (d_pad - a.shape[-1],), -1, a.dtype)
            a = np.concatenate([a, pad], axis=-1)[..., start:stop]
        return a

    return conv(ref, "")
