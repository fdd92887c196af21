"""K4, the masked N-Queens move: CUDA on the card, plain PyTorch on the CPU.

The N-Queens problem without ``nbr_axis`` has ``Problem.in_place``
(``core/problem.py``): its descent writes each lane's move into the carry's
own state under the lane mask, and carries its best as the board
(``models/nqueens.py``).  ``nqueens_move(state, moves, idx, mask)`` is that
write, ``InPlace.move``: for the lanes of ``mask`` exactly what ``apply_move``
computes, in the buffers of ``state`` = (rows int64[P, n], rc float32[P, n],
dc float32[P, 2n−1], ac float32[P, 2n−1], cs float32[P, n]), with ``moves`` =
(cols int64[P, A], n) and flat candidate ``idx`` int64[P] moving column
``cols[idx // n]`` to row ``idx % n``.  Every other lane is not written.

- ``nqueens_move`` is the wrapper.  It checks dtypes, shapes, devices and
  contiguity (``cols`` may be a row-strided view, as the neighborhood's sample
  is), takes the plain version for tensors on the CPU, and for tensors on a
  CUDA device launches the kernel in ``csrc/nqueens_move.cu`` or raises:
  there is no fallback.  ``nqueens_move.launches`` counts its launches and
  ``.shapes`` them per (P, A, n), through ``ops/launch_count.py``, so CUDA
  graph replays count too.  It returns None.
- ``nqueens_move_ref`` is the plain version: ``apply_move``'s arithmetic, the
  counters' cells and the moved row written under the mask, the column
  scores through ``torch.where(..., out=cs)``.
- The kernel (its design is in the source) runs one block a lane over the
  lane's n columns; ``_launch_plan(n)`` gives the block's threads.
- ``kernel_work(p, n, masked, changed)`` is one call's (operations, bytes) by
  formula, given the lanes its mask holds and the column scores its moves
  change; ``move_work`` reads those two counts from a call's data, and is
  what the wrapper reports to ``utils/roofline.py`` for the call.
- ``build_library`` compiles the kernel with ``nvcc`` into ``build/kernels/`` at
  first use and loads it with ``ctypes``, through ``ops/nqueens_kernel.py``'s
  ``KernelLibrary``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from constraint_solver_tpu_torch.ops import launch_count
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "nqueens_move.cu"
_LIB_PATH = nk._BUILD_DIR / "libnqueens_move.so"
KERNEL_NAME = "nqueens_move"
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LIBRARY = nk.KernelLibrary(_SRC, _LIB_PATH, {"nqueens_move_launch": _ARGS})
UNROLL = 16  # columns a thread loads before it computes any (csrc kUnroll)
MIN_THREADS, MAX_THREADS = 64, 1024  # a block's threads (csrc kMaxThreads)
MAX_N = 1 << 29  # the kernel's int arithmetic on rows and diagonals


@functools.lru_cache(maxsize=64)
def _launch_plan(n: int) -> int:
    """A block's threads for a lane of n columns: the power of two that gives
    every thread at most ``UNROLL`` columns, within [64, 1024]."""
    threads = MIN_THREADS
    while threads < MAX_THREADS and threads * UNROLL < n:
        threads *= 2
    return threads


def kernel_work(p: int, n: int, masked: int | None = None, changed: int = 0) -> tuple[int, int]:
    """(operations, bytes) of one call over P lanes of n columns, ``masked``
    of them in the mask (by default all P), whose moves change ``changed``
    column scores besides the moved columns'.  Operations: 13 integer
    operations a column of a masked lane (two line indices, six compares, five
    adds), one float add a changed score.  Bytes: idx and mask read once (9
    bytes a lane); a masked lane's rows read (8 bytes a column), its column
    index read, its moved row written, six counter cells read and written and
    the moved column's score written (68 bytes); each changed score read and
    written (8 bytes)."""
    if masked is None:
        masked = p
    return 13 * masked * n + changed, 9 * p + masked * (8 * n + 68) + 8 * changed


def move_work(state, moves, idx, mask) -> tuple[int, int]:
    """``kernel_work`` of this call's data: the lanes ``mask`` holds and the
    column scores their moves change (Δj != 0 off the moved column), read
    before the move.  It reads those counts to the host."""
    _, col, _, _, delta = _deltas(state, moves, idx)
    off_col = torch.arange(moves[1], device=col.device) != col[:, None]
    changed = int(((delta != 0) & off_col & mask[:, None]).sum())
    return kernel_work(state[0].shape[0], moves[1], int(mask.sum()), changed)


def check_inputs(state, moves, idx, mask) -> tuple[int, int, int]:
    rows, rc, dc, ac, cs = state
    cols, n = moves
    if rows.dim() != 2 or cols.dim() != 2:
        raise ValueError(f"rows must be [P, n] and cols [P, A], got {tuple(rows.shape)} and {tuple(cols.shape)}")
    p, a = cols.shape
    if n > MAX_N:
        raise ValueError(f"n must be at most {MAX_N}, got {n}")
    if rows.shape != (p, n) or n < 1 or a < 1:
        raise ValueError(f"rows must be [P, n] = {(p, n)} with n, A >= 1, got {tuple(rows.shape)} and A = {a}")
    device = rows.device
    f32, i64 = torch.float32, torch.int64
    for name, t, dtype, shape in (
        ("rows", rows, i64, (p, n)), ("rc", rc, f32, (p, n)), ("dc", dc, f32, (p, 2 * n - 1)),
        ("ac", ac, f32, (p, 2 * n - 1)), ("cs", cs, f32, (p, n)), ("idx", idx, i64, (p,)),
        ("mask", mask, torch.bool, (p,)),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous with shape {shape} on {device}, got shape "
                f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}"
            )
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


def nqueens_move_ref(state, moves, idx, mask) -> None:
    """Plain version: ``apply_move``'s arithmetic, written into ``state`` in
    the lanes of ``mask`` only."""
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


def build_library(force: bool = False) -> str:
    """Compile ``csrc/nqueens_move.cu`` into ``build/kernels/`` if the library
    is missing, older than its source, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    return _LIBRARY.build(force)


def nqueens_move(state, moves, idx, mask) -> None:
    """K4: each lane's move ``idx`` int64[P] of ``moves`` = (cols int64[P, A],
    n) written into ``state`` = (rows, rc, dc, ac, cs) in the lanes of
    ``mask`` bool[P]; all on one device.  Returns None."""
    p, a, n = check_inputs(state, moves, idx, mask)
    count = roofline.active_count()
    if count is not None:
        # Counted by formula on this call's data; the ops issued below are not counted.
        with count.muted():
            work = move_work(state, moves, idx, mask)
        with count.kernel(KERNEL_NAME, *work):
            _move(state, moves[0], idx, mask, p, a, n)
        return
    _move(state, moves[0], idx, mask, p, a, n)


def _move(state, cols, idx, mask, p: int, a: int, n: int) -> None:
    if idx.device.type == "cpu":
        nqueens_move_ref(state, (cols, n), idx, mask)
        return
    if p == 0:
        return
    index = idx.device.index
    threads = _launch_plan(n)
    ptrs = [t.data_ptr() for t in (*state, cols, idx, mask)]
    nk.launch(_LIBRARY.entry("nqueens_move_launch"), (*ptrs, p, n, a, cols.stride(0), threads), index,
              f"(P, A, n) = {(p, a, n)}, {threads} threads a lane")
    launch_count.count(nqueens_move, (p, a, n))


launch_count.counted(nqueens_move)  # .launches, and .shapes per (P, A, n)
