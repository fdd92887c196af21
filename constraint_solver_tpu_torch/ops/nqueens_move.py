"""K4, the masked N-Queens move: CUDA on the card, plain PyTorch on the CPU.

The N-Queens problem without ``nbr_axis`` has ``Problem.in_place``
(``core/problem.py``) with ``saves_best``: its descent writes each lane's move
into the carry's own state under the lane mask, and its best board in the same
call (``models/nqueens.py``).  ``nqueens_move(state, moves, idx, mask, best,
save)`` is that write, ``InPlace.move``: for the lanes of ``mask`` exactly what
``apply_move`` computes, in the buffers of ``state`` = (rows int64[P, n], rc
float32[P, n], dc float32[P, 2n−1], ac float32[P, 2n−1], cs float32[P, n]),
with ``moves`` = (cols int64[P, A], n) and flat candidate ``idx`` int64[P]
moving column ``cols[idx // n]`` to row ``idx % n``; and, when ``best``
int64[P, n] and ``save`` bool[P] are given, the board after the move copied
into ``best`` for the lanes of ``save`` (a lane outside ``mask`` copies its
board as it is).  Every other lane is not written.

- ``nqueens_move`` is the wrapper.  It checks dtypes, shapes, devices and
  contiguity (``cols`` may be a row-strided view, as the neighborhood's sample
  is; ``best`` may share no memory with ``rows``), takes the plain version
  for tensors on the CPU, and for tensors on a CUDA device launches the kernel
  in ``csrc/nqueens_move.cu`` or raises: there is no fallback.
  ``nqueens_move.launches`` counts its launches and ``.shapes`` them per (P,
  A, n), through ``ops/launch_count.py``, so CUDA graph replays count too.  It
  returns None.
- ``nqueens_move_ref`` is the plain version: ``apply_move``'s arithmetic, the
  counters' cells and the moved row written under the mask, the column
  scores through ``torch.where(..., out=cs)``, then the best board through
  ``torch.where(..., out=best)``.
- ``_launch_plan(p, n, sms)`` is the launch (its design is in the source), a
  pure function of the shapes and the card's SM count: S blocks a lane, one
  thread-block cluster when S > 1, S the smallest power of two with P·S ≥ the
  SMs, at most ``MAX_SLICES`` (the portable cluster size), and no larger than
  leaves every block ``MIN_CHUNK`` columns: S = 8 at (16, 64, 16384), 1 at
  (256, 50, 1000); a block has up to ``MAX_THREADS`` threads, about
  ``SPREAD`` columns each (256 at both shapes), and each thread loads up to
  ``COLUMNS`` columns at once.  The wrapper's private ``_slices`` forces S
  (1 to 8) for the chip's bit-for-bit checks.
- ``kernel_work(p, n, masked, changed, saved, saved_only)`` is one call's
  (operations, bytes) by formula, given the lanes its masks hold and the
  column scores its moves change; ``move_work`` reads those counts from a
  call's data, and is what the wrapper reports to ``utils/roofline.py`` for
  the call.
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
from constraint_solver_tpu_torch.ops.block_pick import _sms
from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "nqueens_move.cu"
_LIB_PATH = nk._BUILD_DIR / "libnqueens_move.so"
KERNEL_NAME = "nqueens_move"
_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_LIBRARY = nk.KernelLibrary(_SRC, _LIB_PATH, {"nqueens_move_launch": _ARGS})
COLUMNS = 16  # columns a thread loads at most before it computes any (csrc kColumns)
SPREAD = 4  # columns a thread of a block below MAX_THREADS takes at most
MIN_THREADS, MAX_THREADS = 32, 256  # a block's threads (csrc kMaxThreads)
MAX_SLICES = 8  # blocks a lane: the portable cluster size (csrc kMaxSlices)
MIN_CHUNK = 1024  # columns a block of a cluster takes at least
MAX_N = 1 << 29  # the kernel's int arithmetic on rows and diagonals


class LaunchPlan(NamedTuple):
    slices: int  # S: blocks a lane, one cluster (S, 1, 1) when S > 1
    threads: int  # a block's threads
    grid: int  # P·S blocks


@functools.lru_cache(maxsize=64)
def _launch_plan(p: int, n: int, sms: int, slices: int | None = None) -> LaunchPlan:
    """K4's launch for P lanes of n columns on a card of ``sms`` SMs (S
    forced by ``slices``): S as the module says, and the power of two of
    threads, in [32, 256], that gives each at most ``SPREAD`` columns of the
    largest chunk (cut in pairs of columns)."""
    s = slices or 1
    while slices is None and s < MAX_SLICES and p * s < sms and n >= 2 * s * MIN_CHUNK:
        s *= 2
    chunk = 2 * -(-n // (2 * s))
    threads = MIN_THREADS
    while threads < MAX_THREADS and threads * SPREAD < chunk:
        threads *= 2
    return LaunchPlan(s, threads, p * s)


def kernel_work(p: int, n: int, masked: int | None = None, changed: int = 0, saved: int | None = None,
                saved_only: int = 0) -> tuple[int, int]:
    """(operations, bytes) of one call over P lanes of n columns, ``masked``
    of them in the mask (by default all P), whose moves change ``changed``
    column scores besides the moved columns'; with a best board (``saved`` not
    None) ``saved`` lanes in ``save``, ``saved_only`` of them outside the
    mask.  Operations: 13 integer operations a column of a masked lane (two
    line indices, six compares, five adds), one float add a changed score.
    Bytes: idx and mask read once (9 bytes a lane); a masked lane's rows read
    (8 bytes a column), its column index read, its moved row written, six
    counter cells read and written and the moved column's score written (68
    bytes); each changed score read and written (8 bytes); with a best board
    ``save`` read (a byte a lane), each saving lane's board written (8 bytes
    a column) and a saving lane outside the mask's rows read (8 bytes a
    column)."""
    if masked is None:
        masked = p
    nbytes = 9 * p + masked * (8 * n + 68) + 8 * changed
    if saved is not None:
        nbytes += p + 8 * n * (saved + saved_only)
    return 13 * masked * n + changed, nbytes


def move_work(state, moves, idx, mask, best=None, save=None) -> tuple[int, int]:
    """``kernel_work`` of this call's data: the lanes ``mask`` and ``save``
    hold and the column scores the moves change (Δj != 0 off the moved
    column), read before the move.  It reads those counts to the host."""
    _, col, _, _, delta = _deltas(state, moves, idx)
    off_col = torch.arange(moves[1], device=col.device) != col[:, None]
    changed = int(((delta != 0) & off_col & mask[:, None]).sum())
    saved, saved_only = None, 0
    if best is not None:
        saved, saved_only = int(save.sum()), int((save & ~mask).sum())
    return kernel_work(state[0].shape[0], moves[1], int(mask.sum()), changed, saved, saved_only)


def check_inputs(state, moves, idx, mask, best=None, save=None) -> tuple[int, int, int]:
    rows, rc, dc, ac, cs = state
    cols, n = moves
    if rows.dim() != 2 or cols.dim() != 2:
        raise ValueError(f"rows must be [P, n] and cols [P, A], got {tuple(rows.shape)} and {tuple(cols.shape)}")
    p, a = cols.shape
    if n > MAX_N:
        raise ValueError(f"n must be at most {MAX_N}, got {n}")
    if rows.shape != (p, n) or n < 1 or a < 1:
        raise ValueError(f"rows must be [P, n] = {(p, n)} with n, A >= 1, got {tuple(rows.shape)} and A = {a}")
    if (best is None) != (save is None):
        raise ValueError("best and save go together")
    device = rows.device
    f32, i64 = torch.float32, torch.int64
    named = [("rows", rows, i64, (p, n)), ("rc", rc, f32, (p, n)), ("dc", dc, f32, (p, 2 * n - 1)),
             ("ac", ac, f32, (p, 2 * n - 1)), ("cs", cs, f32, (p, n)), ("idx", idx, i64, (p,)),
             ("mask", mask, torch.bool, (p,))]
    if best is not None:
        named += [("best", best, i64, (p, n)), ("save", save, torch.bool, (p,))]
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous with shape {shape} on {device}, got shape "
                f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}"
            )
    if best is not None and best.untyped_storage().data_ptr() == rows.untyped_storage().data_ptr():
        raise ValueError("best must share no memory with rows")
    if cols.dtype != i64:
        raise TypeError(f"cols must be {i64}, got {cols.dtype}")
    if (cols.device != device or (a > 1 and cols.stride(1) != 1)
            or not (a if p > 1 else 1) <= cols.stride(0) < 2**31):
        raise ValueError(f"cols must be on {device} with rows of unit stride, got strides {cols.stride()} on "
                         f"{cols.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return p, a, n


def _deltas(state, moves, idx):
    """Each lane's decoded move (lane, col, r_old, r_new) and the change Δj
    float32[P, n] of every column score against the old board (at col the
    move sets the score instead)."""
    rows = state[0]
    cols, n = moves
    lane = torch.arange(rows.shape[0], device=rows.device)
    col = cols[lane, idx // n]
    r_old, r_new = rows[lane, col], idx % n
    d_old, d_new = r_old - col + (n - 1), r_new - col + (n - 1)
    a_old, a_new = r_old + col, r_new + col
    iota = torch.arange(n, device=rows.device)
    dj, aj = rows - iota + (n - 1), rows + iota

    def eq(x, v):
        return (x == v[:, None]).to(torch.float32)

    delta = (eq(rows, r_new) - eq(rows, r_old) + eq(dj, d_new) - eq(dj, d_old)
             + eq(aj, a_new) - eq(aj, a_old))
    return lane, col, r_old, r_new, delta


def nqueens_move_ref(state, moves, idx, mask, best=None, save=None) -> None:
    """Plain version: ``apply_move``'s arithmetic, written into ``state`` in
    the lanes of ``mask`` only, then the boards of the lanes of ``save`` into
    ``best``."""
    rows, rc, dc, ac, cs = state
    n = moves[1]
    lane, col, r_old, r_new, delta = _deltas(state, moves, idx)
    d_old, d_new = r_old - col + (n - 1), r_new - col + (n - 1)
    a_old, a_new = r_old + col, r_new + col
    moved_cs = cs + delta
    for t, old, new in ((rc, r_old, r_new), (dc, d_old, d_new), (ac, a_old, a_new)):
        t[lane, old] = torch.where(mask, t[lane, old] - 1.0, t[lane, old])
        t[lane, new] = torch.where(mask, t[lane, new] + 1.0, t[lane, new])
    moved_cs[lane, col] = (rc[lane, r_new] - 1) + (dc[lane, d_new] - 1) + (ac[lane, a_new] - 1)
    torch.where(mask[:, None], moved_cs, cs, out=cs)
    rows[lane, col] = torch.where(mask, r_new, r_old)
    if best is not None:
        torch.where(save[:, None], rows, best, out=best)


def build_library(force: bool = False) -> str:
    """Compile ``csrc/nqueens_move.cu`` into ``build/kernels/`` if the library
    is missing, older than its source, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    return _LIBRARY.build(force)


def nqueens_move(state, moves, idx, mask, best=None, save=None, *, _slices=None) -> None:
    """K4: each lane's move ``idx`` int64[P] of ``moves`` = (cols int64[P, A],
    n) written into ``state`` = (rows, rc, dc, ac, cs) in the lanes of
    ``mask`` bool[P], and the moved boards into ``best`` int64[P, n] in the
    lanes of ``save`` bool[P] (both or neither); all on one device.
    ``_slices`` forces S on the card.  Returns None."""
    p, a, n = check_inputs(state, moves, idx, mask, best, save)
    if _slices is not None and not 1 <= _slices <= MAX_SLICES:
        raise ValueError(f"_slices must be 1 to {MAX_SLICES}, got {_slices}")
    count = roofline.active_count()
    if count is not None:
        # Counted by formula on this call's data; the ops issued below are not counted.
        with count.muted():
            work = move_work(state, moves, idx, mask, best, save)
        with count.kernel(KERNEL_NAME, *work):
            _move(state, moves[0], idx, mask, best, save, p, a, n, _slices)
        return
    _move(state, moves[0], idx, mask, best, save, p, a, n, _slices)


def _move(state, cols, idx, mask, best, save, p: int, a: int, n: int, slices) -> None:
    if idx.device.type == "cpu":
        nqueens_move_ref(state, (cols, n), idx, mask, best, save)
        return
    if p == 0:
        return
    index = idx.device.index
    plan = _launch_plan(p, n, _sms(index), slices)
    boards = (state[0],) if best is None else (state[0], best)
    vec = int(n % 2 == 0 and all(t.data_ptr() % 16 == 0 for t in boards))
    ptrs = [t.data_ptr() for t in (*state, cols, idx, mask)]
    ptrs += [None, None] if best is None else [best.data_ptr(), save.data_ptr()]
    nk.launch(_LIBRARY.entry("nqueens_move_launch"),
              (*ptrs, p, n, a, cols.stride(0), plan.threads, plan.slices, vec), index,
              f"(P, A, n) = {(p, a, n)}, {plan.slices} blocks of {plan.threads} threads a lane")
    launch_count.count(nqueens_move, (p, a, n))


launch_count.counted(nqueens_move)  # .launches, and .shapes per (P, A, n)
