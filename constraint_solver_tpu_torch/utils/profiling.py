"""Profiling helpers (port of ``constraint_solver_tpu/utils/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that records
  the host's ops and, where there is a CUDA device, the card's kernels, and
  writes them into ``logdir`` as one Chrome trace (``trace.<pid>.<ns>.json``,
  viewable in Perfetto or ``chrome://tracing``).  It yields the profiler, whose
  ``events()`` the caller may read after the block.
- ``annotate(name)``: a named span of host-side work in that trace
  (``torch.profiler.record_function``).

Divergence: the JAX ``trace`` turns a profiler that fails to start or stop
into a warning and carries on; here the failure raises, so a run that asked
for a trace never ends without one.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def annotate(name: str):
    return record_function(name)
