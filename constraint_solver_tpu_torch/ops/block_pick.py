"""K3, the block pick: a descent's pick from a row block of candidate scores,
CUDA on the card, plain PyTorch on the CPU.

A neighborhood may hand the engine its scores as a row block
(``core/problem.py`` ``RowBlock``): hard float32[P, R, C] with a soft channel
that is identically 0, bool row_valid[P, R] (every candidate of a row valid, or
none), and each row's minimum float32[P, R] and the first index of it int32[P,
R], B1's by-products (``ops/nqueens_kernel.py``).  Flat candidate i = j·C + k is
row j's entry k.  ``block_pick`` gives, for each lane,

    lex_argmin(make_score(hard.view(P, R*C)), mask)     (``ops/lex.py``)

where ``mask`` is row_valid repeated C times with every index in ``excl``
int64[P, E] removed (-1 marks an empty slot; any value that is no flat index
never matches): the lowest flat index among the minima, and 0 when a lane has
no candidate left.  With no exclusion it is the descent's first pick
(``Neighborhood.hint_idx``); with the examined candidates it is a retry's pick
of pick-then-check (``core/local_search.py`` ``_retry``).

- ``block_pick`` is the wrapper.  It checks dtypes, shapes, devices and
  contiguity, takes the plain version for tensors on the CPU, and for tensors on
  a CUDA device launches the kernel in ``csrc/block_pick.cu`` or raises: there
  is no fallback.  ``block_pick.launches`` counts its launches and ``.shapes``
  them per (P, R, C, E), through ``ops/launch_count.py``, so CUDA graph replays
  count too.
- ``block_pick_ref`` is the plain version: the chain the engine ran before K3,
  the score block stacked, the mask built as ``_retry`` built it, and
  ``lex_argmin`` over the whole block.  ``excluded`` is that mask's exclusion
  step, which the engine still takes for scores handed over whole.
- The kernel reads only [P, R] and rescans the at most E rows whose first
  minimum is excluded (the algorithm is in the source).  It trusts the row
  minima to be the block's: row_min[p, j] is hard[p, j].amin() and row_arg[p,
  j] the first index holding it.  Under that precondition it equals the plain
  version bit for bit.
- ``_launch_plan(p, r, c, e, sms)`` is the launch, a pure function of the
  shapes and the card's SM count: a first pick (E = 0) is one block of
  ``PICK_THREADS`` a lane; a retry is S blocks of ``RETRY_THREADS`` a lane,
  one thread-block cluster, each block folding a contiguous slice of the
  queued rows.  S is the smallest power of two with P·S ≥ the SMs, at most
  ``MAX_SLICES`` (the portable cluster size), and no larger than leaves every
  block ``RETRY_THREADS`` 16-byte items of one row: every retry of the
  N-Queens solves rescans one row a lane (``chip_smoke.py --k3-solves``), and
  R and E do not enter.  S = 8 at (16, 64, 16384), the fastest of S = 1, 2, 4
  and 8 there at one row and at eight (``chip_smoke.py`` phase 2e); S = 1 at
  (256, 50, 1000) and for rows under 2048 candidates.  With nothing to
  rescan a cluster costs about 1 us more than one block, and no solve's
  retry has nothing to rescan at (16, 64, 16384).  The wrapper's private
  ``_slices`` forces S (1 to 8) for the chip's comparisons.
- ``kernel_work(p, r, c, e, rescanned)`` is one call's (operations, bytes) by
  formula: what ``utils/roofline.py`` counts for the call (with the most rows a
  call can rescan, P·min(E, R)), and, given the rows that a call's data
  rescans, what that call needs.
- ``build_library`` compiles the kernel with ``nvcc`` into ``build/kernels/`` at
  first use and loads it with ``ctypes``, through ``ops/nqueens_kernel.py``'s
  ``KernelLibrary``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.ops import launch_count
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops.lex import lex_argmin, make_score
from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "block_pick.cu"
_LIB_PATH = nk._BUILD_DIR / "libblock_pick.so"
KERNEL_NAME = "block_pick"
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LIBRARY = nk.KernelLibrary(_SRC, _LIB_PATH, {"block_pick_launch": _ARGS})
MAX_EXCL = 256  # exclusion slots a lane (csrc kMaxExcl)
PICK_THREADS, RETRY_THREADS = 128, 256  # a block's threads without and with exclusions (csrc)
MAX_SLICES = 8  # blocks a lane: the portable cluster size (csrc kMaxSlices)


class LaunchPlan(NamedTuple):
    slices: int  # S: blocks a lane, one cluster (S, 1, 1) when S > 1
    threads: int  # a block's threads
    grid: int  # P·S blocks


@functools.lru_cache(maxsize=64)
def _launch_plan(p: int, r: int, c: int, e: int, sms: int) -> LaunchPlan:
    """K3's launch for P lanes of R rows of C candidates with E exclusion
    slots on a card of ``sms`` SMs."""
    if e == 0:
        return LaunchPlan(1, PICK_THREADS, p)
    items = -(-c // 4)  # 16-byte items of one row: the rows a lane rescans in the solves' retries
    s = 1
    while s < MAX_SLICES and p * s < sms and items >= 2 * s * RETRY_THREADS:
        s *= 2
    return LaunchPlan(s, RETRY_THREADS, p * s)


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def excluded(valid: torch.Tensor, excl: torch.Tensor | None) -> torch.Tensor:
    """``valid`` [P, W] with every index in ``excl`` [P, E] removed (-1 slots
    never match)."""
    if excl is None:
        return valid
    iota_w = torch.arange(valid.shape[1], device=valid.device)
    mask = valid
    for k in range(excl.shape[1]):
        mask = mask & (iota_w != excl[:, k : k + 1])
    return mask


def block_pick_ref(hard, row_valid, row_min, row_arg, excl=None) -> torch.Tensor:
    """Plain version: ``lex_argmin`` over the stacked score block, under the row
    validity with ``excl`` removed.  ``row_min`` and ``row_arg`` are not read."""
    p, r, c = hard.shape
    valid = row_valid[:, :, None].expand(p, r, c).reshape(p, r * c)
    return lex_argmin(make_score(hard.reshape(p, r * c)), excluded(valid, excl))


def kernel_work(p: int, r: int, c: int, e: int, rescanned: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one call; ``rescanned``: the rows the call scans
    again, at most (and by default) P·min(E, R).  Operations: per row its E
    exclusion compares and one fold, per rescanned entry the same.  Bytes:
    row_valid, row_min and row_arg read once (9 bytes a row), ``excl`` once,
    each rescanned row once, the output written once."""
    if rescanned is None:
        rescanned = p * min(e, r)
    return (p * r + rescanned * c) * (e + 1), 9 * p * r + 8 * p * e + 4 * rescanned * c + 8 * p


def check_inputs(hard, row_valid, row_min, row_arg, excl) -> tuple[int, int, int, int]:
    if hard.dim() != 3:
        raise ValueError(f"hard must be [P, R, C], got {tuple(hard.shape)}")
    p, r, c = hard.shape
    if r * c == 0:
        raise ValueError(f"a row block of no candidate: {tuple(hard.shape)}")
    e = 0 if excl is None else excl.shape[-1]
    if e > MAX_EXCL:
        raise ValueError(f"at most {MAX_EXCL} exclusions a lane, got {e}")
    device = hard.device
    named = [("hard", hard, torch.float32, (p, r, c)), ("row_valid", row_valid, torch.bool, (p, r)),
             ("row_min", row_min, torch.float32, (p, r)), ("row_arg", row_arg, torch.int32, (p, r))]
    if excl is not None:
        named.append(("excl", excl, torch.int64, (p, e)))
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous with shape {shape} on {device}, got shape "
                f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}"
            )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return p, r, c, e


def build_library(force: bool = False) -> str:
    """Compile ``csrc/block_pick.cu`` into ``build/kernels/`` if the library is
    missing, older than its source, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    return _LIBRARY.build(force)


def block_pick(hard, row_valid, row_min, row_arg, excl=None, *, _slices=None) -> torch.Tensor:
    """K3: each lane's pick, int64[P], from the row block (hard float32[P, R, C],
    row_valid bool[P, R], row_min float32[P, R], row_arg int32[P, R]) with the
    candidates in ``excl`` int64[P, E] (or None) removed; all contiguous, on one
    device.  ``_slices`` forces the plan's S on the card."""
    p, r, c, e = check_inputs(hard, row_valid, row_min, row_arg, excl)
    if _slices is not None and not (1 <= _slices <= MAX_SLICES and (e or _slices == 1)):
        raise ValueError(f"_slices must be 1 to {MAX_SLICES} with exclusions, 1 without; got {_slices}")
    count = roofline.active_count()
    if count is not None:
        # Counted by formula; the ops issued below are not counted.
        with count.kernel(KERNEL_NAME, *kernel_work(p, r, c, e)):
            return _pick(hard, row_valid, row_min, row_arg, excl, p, r, c, e, _slices)
    return _pick(hard, row_valid, row_min, row_arg, excl, p, r, c, e, _slices)


def _pick(hard, row_valid, row_min, row_arg, excl, p, r, c, e, slices):
    if hard.device.type == "cpu":
        return block_pick_ref(hard, row_valid, row_min, row_arg, excl)
    out = row_min.new_empty((p,), dtype=torch.int64)
    if p == 0:
        return out
    index = hard.device.index
    if slices is None:
        slices = _launch_plan(p, r, c, e, _sms(index)).slices
    vec = int(c % 4 == 0 and hard.data_ptr() % 16 == 0)
    ptrs = [t.data_ptr() for t in (hard, row_valid, row_min, row_arg)]
    nk.launch(_LIBRARY.entry("block_pick_launch"),
              (*ptrs, excl.data_ptr() if e else None, out.data_ptr(), p, r, c, e, vec, slices),
              index, f"(P, R, C, E) = {(p, r, c, e)}, {slices} blocks a lane")
    launch_count.count(block_pick, (p, r, c, e))
    return out


launch_count.counted(block_pick)  # .launches, and .shapes per (P, R, C, E)
