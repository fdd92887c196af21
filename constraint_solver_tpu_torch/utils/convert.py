"""Solver state carried between the JAX package and the port.

There are no weights in this system: its "parameters" are the solver state.
``from_reference`` turns a JAX ``IlsState`` (or any tree of ``NamedTuple``s with
the same class and field names and array leaves with a leading lane axis P:
boards, counters, tabu ring, elite archive, uint32 fingerprints) into the port's
state on a given device.  ``to_reference`` turns the port's state back into the
same tree with numpy leaves in the JAX package's dtypes.  The JAX state's PRNG
``key`` has no counterpart (``utils/draws.py``) and is skipped.

Dtype map: fingerprint fields (uint32 there, int64 in [0, 2^32) here) and boards
(``rows``: int32 there, int64 here) convert exactly; every other leaf keeps its
dtype.  A single JAX ``Solver``'s state has no lane axis: give it one first.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from constraint_solver_tpu_torch.core.history import EliteArchive, TabuRing
from constraint_solver_tpu_torch.core.ils import IlsState
from constraint_solver_tpu_torch.models.nqueens import NQState

_CLASSES = {cls.__name__: cls for cls in (IlsState, EliteArchive, TabuRing, NQState)}
_FP_FIELDS = ("fps", "current_fp")


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
        if a.dtype == np.uint32 or field == "rows":
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
