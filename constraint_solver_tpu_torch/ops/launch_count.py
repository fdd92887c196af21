"""Launch counters of the hand-written kernels, through CUDA graph captures and replays.

Each kernel wrapper carries ``.launches`` (its kernel launches) and ``.shapes``
(a ``Counter`` of them per shape), set by ``counted``, and reports each launch
through ``count``.  While a thread captures a CUDA graph (``captured``) its
launches go to the capture's tally instead, keyed by (wrapper, shape): a
capture records a kernel, it does not launch it.  ``count_replay`` adds a
tally once per replay of its graph (``core/graphed.py``), so a graphed run's
counters equal the eager run's, whichever kernels its graphs hold.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Callable

_capturing = threading.local()  # .tally: this thread's launches while it captures a CUDA graph
_LOCK = threading.Lock()  # the service's handler threads launch at once


def counted(wrapper: Callable) -> Callable:
    """``wrapper`` with its counters at 0."""
    wrapper.launches = 0
    wrapper.shapes = Counter()
    return wrapper


def count(wrapper: Callable, shape: tuple) -> None:
    """One launch of ``wrapper``'s kernel at ``shape``, on its counters or, while
    this thread captures a CUDA graph, on the capture's tally."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally[(wrapper, shape)] += 1
        return
    with _LOCK:
        wrapper.launches += 1
        wrapper.shapes[shape] += 1


@contextlib.contextmanager
def captured():
    """Within the block this thread's launches go to the yielded ``Counter``
    (per (wrapper, shape)) instead of the counters."""
    tally = _capturing.tally = Counter()
    try:
        yield tally
    finally:
        _capturing.tally = None


def count_replay(tally: Counter) -> None:
    """The launches of one replay of a graph that captured ``tally``."""
    with _LOCK:
        for (wrapper, shape), k in tally.items():
            wrapper.launches += k
            wrapper.shapes[shape] += k
