"""K6, the N-Queens column sample and the block's inputs: CUDA on the card, plain PyTorch on the CPU.

The N-Queens neighborhood (``models/nqueens.py``) samples A conflicted columns
a lane by Gumbel top-k and hands B1 (``ops/nqueens_kernel.py``) each sampled
column's row and removed term.  ``nqueens_sample(cs, table, gumbel, num_cols,
n_conflicted, rows, rc, dc, ac, a)`` is all of it in one call, given the
column scores cs float32[P, n], the log-weight table float32[≥ 3n], the draws
(gumbel float32[P, n], num_cols int64[P]), the conflicted columns' count
n_conflicted int64[P] and the board's counters (rows int64[P, n], rc
float32[P, n], dc and ac float32[P, 2n−1]).  With the key of column j

    k_j = (cs_j > 0 ? table[cs_j] : −inf) + gumbel_j      (one float32 add)

it returns a ``Sample``: the A columns of the largest keys, in descending key
order with the lower column first among equal keys (the stable sort's order,
and ``lax.top_k``'s), as int64 ``cols`` [P, A] (``NQMoves.cols``) and int32
``c`` [P, A]; their rows ``r`` int32 [P, A]; ``removed`` float32 [P, A],
((rc[r] − 1) + (dc[r − c + n − 1] − 1)) + (ac[r + c] − 1); ``col_valid``
bool [P, A], i < min(num_cols, n_conflicted); and ``n_valid`` int64 [P], that
count times n.  ``c``, ``r`` and ``removed`` are contiguous, as B1 takes them.

- ``nqueens_sample`` is the wrapper.  It checks dtypes, shapes, devices and
  contiguity, takes the plain version for tensors on the CPU, and for tensors
  on a CUDA device launches the kernel in ``csrc/nqueens_sample.cu`` or
  raises: there is no fallback.  ``nqueens_sample.launches`` counts its
  launches and ``.shapes`` them per (P, n, A), through
  ``ops/launch_count.py``, so CUDA graph replays count too.  No host read,
  and its outputs and scratches come from the caching allocator: a CUDA graph
  captures the call.
- ``nqueens_sample_ref`` is the plain version: the chain the neighborhood ran
  before K6, ``torch.where``, a stable descending ``torch.sort`` of the whole
  [P, n], and the gathers.
- ``_launch_plan(p, n, a)`` is the launch (the algorithm is in the source), a
  pure function of the shapes: one block a lane of ``threads`` (256 up to
  ``MAX_THREADS``: the fewest that give each thread at most
  ``KEYS_PER_THREAD`` keys; 256 at (256, 1000, 50), 1024 at (16, 16384,
  64)); the keys in shared memory where they fit beside the survivors,
  else in a global scratch the wrapper allocates; the A survivors, padded to
  a power of two, in shared memory where they fit, else in a global scratch;
  the survivors placed by rank up to 256 of them, else by a bitonic sort.
  Each branch has shapes at which the plan takes it: the bitonic sort above
  A = 256, the survivors in global memory above A = 16,384, the keys where
  their 4n bytes do not fit beside the survivors (n above about 57,000).
- ``kernel_work(p, n, a)`` is one call's (operations, bytes) by formula:
  what ``utils/roofline.py`` counts for the call.
- ``build_library`` compiles the kernel with ``nvcc`` into ``build/kernels/``
  at first use and loads it with ``ctypes``, through ``ops/nqueens_kernel.py``'s
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
from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "nqueens_sample.cu"
_LIB_PATH = nk._BUILD_DIR / "libnqueens_sample.so"
KERNEL_NAME = "nqueens_sample"
_PLAN_ARGS = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]  # (const long long* plan, void* stream)
_LIBRARY = nk.KernelLibrary(_SRC, _LIB_PATH, {"nqueens_sample_launch": _PLAN_ARGS})
PLAN_LEN = 27  # csrc kPlanLen
RANK_MAX = 256  # the most survivors placed by rank (csrc kRankMax)
MIN_THREADS, MAX_THREADS = 256, 1024  # a block's threads
KEYS_PER_THREAD = 4  # keys a thread takes at most, below MAX_THREADS
SMEM_MAX = 232_448 - 4096  # dynamic shared memory a block may take (csrc kSmemMax)
MAX_N = 1 << 24  # the kernel's int arithmetic on a thread's run of columns


class Sample(NamedTuple):
    cols: torch.Tensor  # int64[P, A]: the sampled columns, ``NQMoves.cols``
    c: torch.Tensor  # int32[P, A]: the same, B1's
    r: torch.Tensor  # int32[P, A]: their rows
    removed: torch.Tensor  # float32[P, A]
    col_valid: torch.Tensor  # bool[P, A]
    n_valid: torch.Tensor  # int64[P]


class LaunchPlan(NamedTuple):
    threads: int  # a block's threads; one block a lane
    per: int  # columns of a thread's contiguous run: ceil(n / threads)
    a_pad: int  # A rounded up to a power of two: the bitonic sort's length
    keys_shared: bool  # the keys in shared memory, else in a [P, n] global scratch
    cands_shared: bool  # the survivors in shared memory, else in a [P, a_pad] global scratch
    smem: int  # dynamic shared memory bytes a block
    rank_sort: bool  # each survivor placed by its rank (A ≤ threads and RANK_MAX), else a bitonic sort


@functools.lru_cache(maxsize=64)
def _launch_plan(p: int, n: int, a: int) -> LaunchPlan:
    """K6's launch for P lanes, n columns and A samples (1 ≤ A ≤ n)."""
    threads = MIN_THREADS
    while threads < MAX_THREADS and threads * KEYS_PER_THREAD < n:
        threads *= 2
    a_pad = 1 << (a - 1).bit_length()
    cand_bytes, key_bytes = 8 * a_pad, 4 * n
    cands_shared = cand_bytes <= SMEM_MAX
    keys_shared = cand_bytes * cands_shared + key_bytes <= SMEM_MAX
    smem = cand_bytes * cands_shared + key_bytes * keys_shared
    ranked = a <= min(threads, RANK_MAX)
    return LaunchPlan(threads, -(-n // threads), a_pad, keys_shared, cands_shared, smem, ranked)


def kernel_work(p: int, n: int, a: int) -> tuple[int, int]:
    """(operations, bytes) of one call.  Operations: per column its key (a
    compare and an add) and one compare that selects it or not; per sampled
    column the removed term's five float operations.  Bytes: cs and gumbel read
    once, num_cols and n_conflicted once, the A sampled entries of rows, rc, dc
    and ac (20 bytes a sample), and the outputs written once (cols 8, c 4, r 4,
    removed 4, col_valid 1 byte a sample; n_valid 8 a lane).  The table is
    read only at the distinct conflict counts, a few dozen bytes that are left
    out."""
    return 3 * p * n + 5 * p * a, 8 * p * n + 16 * p + 41 * p * a + 8 * p


def check_inputs(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a) -> tuple[int, int]:
    if cs.dim() != 2:
        raise ValueError(f"cs must be [P, n], got {tuple(cs.shape)}")
    p, n = cs.shape
    if not 1 <= a <= n:
        raise ValueError(f"A must be 1 to n = {n}, got {a}")
    if n > MAX_N:
        raise ValueError(f"at most {MAX_N} columns, got {n}")
    if table.dim() != 1 or table.shape[0] < 3 * n:
        raise ValueError(f"the log table must be [≥ {3 * n}], got {tuple(table.shape)}")
    device = cs.device
    f32, i64 = torch.float32, torch.int64
    for name, t, dtype, shape in (
        ("cs", cs, f32, (p, n)), ("gumbel", gumbel, f32, (p, n)), ("num_cols", num_cols, i64, (p,)),
        ("n_conflicted", n_conflicted, i64, (p,)), ("rows", rows, i64, (p, n)), ("rc", rc, f32, (p, n)),
        ("dc", dc, f32, (p, 2 * n - 1)), ("ac", ac, f32, (p, 2 * n - 1)), ("table", table, f32, table.shape),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous with shape {shape} on {device}, got shape "
                f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}"
            )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return p, n


def nqueens_sample_ref(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a) -> Sample:
    """Plain version: the eager chain, a stable descending sort of every key."""
    n = cs.shape[1]
    logits = torch.where(cs > 0, table[cs.long()], -torch.inf)
    c = torch.sort(logits + gumbel, dim=-1, descending=True, stable=True).indices[:, :a]
    col_valid = torch.arange(a, device=cs.device) < torch.minimum(num_cols, n_conflicted)[:, None]
    r = rows.gather(1, c)
    removed = (rc.gather(1, r) - 1) + (dc.gather(1, r - c + (n - 1)) - 1) + (ac.gather(1, r + c) - 1)
    return Sample(c, c.to(torch.int32), r.to(torch.int32), removed, col_valid, col_valid.sum(dim=-1) * n)


def build_library(force: bool = False) -> str:
    """Compile ``csrc/nqueens_sample.cu`` into ``build/kernels/`` if the library
    is missing, older than its source, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    return _LIBRARY.build(force)


def _plan_values(plan: LaunchPlan, p: int, n: int, a: int, inputs, out: Sample, key_scratch, cand_scratch) -> list:
    """The C entry's plan: the launch and every pointer (a scratch's 0 where
    its data lives in shared memory)."""
    return [p, n, a, plan.a_pad, plan.threads, plan.per, plan.smem, int(plan.keys_shared), int(plan.cands_shared),
            int(plan.rank_sort), *(t.data_ptr() for t in inputs), *(t.data_ptr() for t in out),
            0 if key_scratch is None else key_scratch.data_ptr(),
            0 if cand_scratch is None else cand_scratch.data_ptr()]


def nqueens_sample(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a: int) -> Sample:
    """K6: the column sample of every lane and B1's inputs (see the module
    docstring); every tensor contiguous and on one device."""
    p, n = check_inputs(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a)
    count = roofline.active_count()
    if count is not None:
        # Counted by formula; the ops issued below are not counted.
        with count.kernel(KERNEL_NAME, *kernel_work(p, n, a)):
            return _sample(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a, p, n)
    return _sample(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a, p, n)


def _sample(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a, p, n) -> Sample:
    if cs.device.type == "cpu":
        return nqueens_sample_ref(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a)
    # ``new_empty`` takes dtype and device from its tensor: less host time than ``torch.empty``.
    out = Sample(rows.new_empty((p, a)), rc.new_empty((p, a), dtype=torch.int32),
                 rc.new_empty((p, a), dtype=torch.int32), rc.new_empty((p, a)),
                 rc.new_empty((p, a), dtype=torch.bool), rows.new_empty((p,)))
    if p == 0:
        return out
    plan = _launch_plan(p, n, a)
    key_scratch = None if plan.keys_shared else rc.new_empty((p, n), dtype=torch.int32)
    cand_scratch = None if plan.cands_shared else rows.new_empty((p, plan.a_pad))
    values = _plan_values(plan, p, n, a, (cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac), out,
                          key_scratch, cand_scratch)
    nk.launch(_LIBRARY.entry("nqueens_sample_launch"), ((ctypes.c_longlong * PLAN_LEN)(*values),), cs.device.index,
              f"(P, n, A) = {(p, n, a)} under {plan}")
    launch_count.count(nqueens_sample, (p, n, a))
    return out


launch_count.counted(nqueens_sample)  # .launches, and .shapes per (P, n, A)
