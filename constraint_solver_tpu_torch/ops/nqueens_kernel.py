"""The N-Queens neighborhood-scoring kernel: CUDA on the card, plain PyTorch on the CPU.

Port of ``constraint_solver_tpu/ops/nqueens_pallas.py``.  For each lane, each of
A sampled columns j and every row r′:

    score = cur + 2·((rc[r′]−[r′=r_j]) + (dc[r′−c_j+n−1]−[r′=r_j])
                     + (ac[r′+c_j]−[r′=r_j]) − removed_j)

plus each row's minimum and its first-index argmin.  Every value is a small
integer in float32, so both versions are exact and equal the TPU kernel bit for bit.

- ``nqueens_neighborhood_scores`` is the wrapper.  It checks device, dtype, shape
  and contiguity in one pass, then takes the plain version for tensors on the
  CPU, and for tensors on a CUDA device launches the kernel in
  ``csrc/nqueens_scores.cu`` or raises: there is no fallback.
  ``nqueens_neighborhood_scores.launches`` counts its kernel launches, and
  ``.shapes`` them per (P, A, n).
- ``nqueens_neighborhood_scores_ref`` is the plain version: windowed gathers of
  the diagonal tables, ``amin`` and first-index ``argmin``.
- ``build_library`` compiles the kernel with ``nvcc`` into ``build/kernels/`` at
  the checkout's root on first use (again whenever the source is newer than the
  library) and loads it with ``ctypes``.  One lock covers the build and the
  load, so threads that reach the kernel's first use together (the server's
  handler threads) build it once, and the temporary file is named by process
  and thread.
- ``kernel_work(p, a, n)`` is the work one call does by formula, (operations,
  bytes): what ``utils/roofline.py`` counts for the call, whatever computes it
  (the kernel's ``ctypes`` launch is invisible to a dispatch mode, and the
  plain version's gathers are not the kernel's work).

The launch plan (``_launch_plan``, a pure function of (P, A, n)): a block holds
G ≤ 8 warps, one sampled column of one lane each, so the grid is (⌈A/G⌉, P).  G
starts at 8 and halves while it is at least twice A or the grid has fewer blocks
than the card's 132 SMs.  A block stages its lane's rc, dc and ac in shared
memory (``staged``) when they fit in the 227 KB a block may use, which holds up
to n = 11,617; above that it reads them from global memory.  Where n % 4 == 0
(``vector``) every row of scores starts on 16 bytes and goes out in 16-byte
stores.

The alignment rule: none beyond the dtype's.  The kernel stages a table from the
16-byte-aligned address at or below its start and reads the scalars one by one,
so inputs that are contiguous views with a storage offset are taken as they are
and give the plain version's bits.  The outputs are allocated here.

Divergences from the TPU kernel: one call covers all P lanes (the JAX package
calls its kernel per lane under ``vmap``); ``cur`` is float32[P]; the unused
``rows`` argument is gone; and one row-min path covers every n.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "nqueens_scores.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_PATH = _BUILD_DIR / "libnqueens_scores.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_MAX_LANES = 65535  # the grid's y dimension
_MAX_WARPS = 8  # columns per block; csrc kMaxWarps
_SMS = 132  # streaming multiprocessors of an H100 SXM
_SMEM_LIMIT = 232_448  # the 227 KB of shared memory one block may use on Hopper

_launch_fn = None
KERNEL_NAME = "nqueens_neighborhood_scores"
_BUILD_LOCK = threading.Lock()  # the lazy build and load of the library


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel is built with the CUDA toolkit")
    return nvcc


def build_library(force: bool = False) -> str:
    """Compile ``csrc/nqueens_scores.cu`` into ``build/kernels/`` if the library
    is missing, older than its source, or ``force`` is set.  Returns the
    compiler's report (``-Xptxas=-v``: registers, shared memory, spills), or ""
    when the library was up to date."""
    with _BUILD_LOCK:
        return _build(force)


def _build(force: bool) -> str:
    return compile_library(_SRC, _LIB_PATH, force)


def compile_library(src: Path, lib: Path, force: bool) -> str:
    """Compile ``src`` with ``nvcc`` into the shared library ``lib`` if it is
    missing, older than its source, or ``force`` is set; the caller holds the
    library's lock.  Returns the compiler's report, or "" when up to date."""
    if not force and lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return proc.stdout + proc.stderr


def _launcher():
    """The C entry ``nqueens_scores_launch``, built and resolved once."""
    global _launch_fn
    if _launch_fn is None:
        with _BUILD_LOCK:
            if _launch_fn is None:
                _build(force=False)
                fn = ctypes.CDLL(str(_LIB_PATH)).nqueens_scores_launch
                fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _launch_fn = fn
    return _launch_fn


def kernel_work(p: int, a: int, n: int) -> tuple[int, int]:
    """(operations, bytes) of one call.  Operations: 8 float32 operations to
    form each of the P·A·n scores (three subtractions of the own-row term, two
    additions, the removed term, the doubling, the current total) and one
    comparison for its row minimum.  Bytes: rc, dc, ac, c, r, removed and cur
    read once, scores, row_min and row_arg written once, 4 bytes each."""
    nbytes = 4 * (p * n + 2 * p * (2 * n - 1) + 3 * p * a + p + p * a * n + 2 * p * a)
    return 9 * p * a * n, nbytes


def _staged_floats(length: int) -> int:
    """Floats of shared memory one staged table of ``length`` floats takes
    (csrc ``staged_floats``): a 0–3 float head, the table and 4 floats of
    room for the second 16-byte load, rounded to 16 bytes."""
    return (length + 10) // 4 * 4


class LaunchPlan(NamedTuple):
    cols_per_block: int  # G: warps per block, one sampled column each
    grid: tuple[int, int]  # (⌈A/G⌉, P)
    smem_bytes: int  # dynamic shared memory per block; 0 unless staged
    staged: bool  # the lane's tables in shared memory, else read from global memory
    vector: bool  # 16-byte score stores (n % 4 == 0)


def columns_per_block(p: int, a: int) -> int:
    """G, the warps of a block, one sampled column each: 8, halved while it is
    at least twice A or the grid of ⌈A/G⌉ × P blocks is smaller than the SMs."""
    g = _MAX_WARPS
    while g > 1 and (g >= 2 * a or -(-a // g) * p < _SMS):
        g //= 2
    return g


@functools.lru_cache(maxsize=64)
def _launch_plan(p: int, a: int, n: int) -> LaunchPlan:
    """The kernel's launch for P lanes, A sampled columns and n rows (P, A ≥ 1)."""
    g = columns_per_block(p, a)
    smem = 4 * (_staged_floats(n) + 2 * _staged_floats(2 * n - 1))
    staged = smem <= _SMEM_LIMIT
    return LaunchPlan(g, (-(-a // g), p), smem if staged else 0, staged, n % 4 == 0)


def check_inputs(rc, dc, ac, c, r, removed, cur) -> tuple[int, int, int]:
    if rc.dim() != 2 or c.dim() != 2:
        raise ValueError(f"rc must be [P, n] and c [P, A], got {tuple(rc.shape)} and {tuple(c.shape)}")
    p, n = rc.shape
    a = c.shape[1]
    table = 2 * n - 1
    device = rc.device
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("rc", rc, f32, (p, n)), ("dc", dc, f32, (p, table)), ("ac", ac, f32, (p, table)),
        ("c", c, i32, (p, a)), ("r", r, i32, (p, a)), ("removed", removed, f32, (p, a)),
        ("cur", cur, f32, (p,)),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous with shape {shape} on {device}, got shape "
                f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}"
            )
    return p, a, n


def nqueens_neighborhood_scores_ref(rc, dc, ac, c, r, removed, cur):
    """Plain PyTorch version.  Returns (scores float32[P, A, n],
    row_min float32[P, A], row_arg int32[P, A])."""
    p, n = rc.shape
    a = c.shape[1]
    rp = torch.arange(n, device=rc.device)
    c = c.long()
    dc_at = dc.gather(1, ((n - 1) - c).unsqueeze(-1).add(rp).reshape(p, a * n)).view(p, a, n)
    ac_at = ac.gather(1, c.unsqueeze(-1).add(rp).reshape(p, a * n)).view(p, a, n)
    same = (rp == r.long().unsqueeze(-1)).to(torch.float32)
    added = (rc.unsqueeze(1) - same) + (dc_at - same) + (ac_at - same)
    scores = cur[:, None, None] + 2.0 * (added - removed.unsqueeze(-1))
    return scores, scores.amin(dim=-1), scores.argmin(dim=-1).to(torch.int32)


def _launch(tensors, p: int, a: int, n: int, plan: LaunchPlan) -> None:
    """Launch the kernel on the tensors' device and its current stream:
    (rc, dc, ac, c, r, removed, cur, scores, row_min, row_arg)."""
    fn = _launcher()
    index = tensors[0].device.index
    ptrs = [t.data_ptr() for t in tensors]
    g, (grid_x, _), smem, staged, vector = plan
    # The raw handle of the current stream, as PyTorch's own kernel launchers
    # read it: ``torch.cuda.current_stream(index).cuda_stream`` builds a Stream
    # object first and costs some 20 times as much host time.
    if index == torch.cuda.current_device():
        err = fn(*ptrs, p, a, n, g, grid_x, smem, staged, vector, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, p, a, n, g, grid_x, smem, staged, vector, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"nqueens_scores_launch failed: cudaError_t {err} for {plan}")
    nqueens_neighborhood_scores.launches += 1
    nqueens_neighborhood_scores.shapes[(p, a, n)] += 1


def nqueens_neighborhood_scores(rc, dc, ac, c, r, removed, cur):
    """The candidate block of every lane.  Inputs: rc float32[P, n], dc/ac
    float32[P, 2n−1], c/r int32[P, A], removed float32[P, A], cur float32[P],
    all contiguous and on one device.  Returns (scores float32[P, A, n],
    row_min float32[P, A], row_arg int32[P, A])."""
    p, a, n = check_inputs(rc, dc, ac, c, r, removed, cur)
    count = roofline.active_count()
    if count is not None:
        # Counted by formula; the ops issued below are not counted.
        with count.kernel(KERNEL_NAME, *kernel_work(p, a, n)):
            return _scores(rc, dc, ac, c, r, removed, cur, p, a, n)
    return _scores(rc, dc, ac, c, r, removed, cur, p, a, n)


def _scores(rc, dc, ac, c, r, removed, cur, p: int, a: int, n: int):
    device = rc.device
    if device.type == "cpu":
        return nqueens_neighborhood_scores_ref(rc, dc, ac, c, r, removed, cur)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if p > _MAX_LANES:
        raise ValueError(f"at most {_MAX_LANES} lanes per launch, got {p}")
    # ``new_empty`` takes dtype and device from its tensor: less host time than
    # ``torch.empty`` with both spelled out.
    scores = rc.new_empty((p, a, n))
    row_min = rc.new_empty((p, a))
    row_arg = c.new_empty((p, a))
    if p * a:
        _launch((rc, dc, ac, c, r, removed, cur, scores, row_min, row_arg), p, a, n, _launch_plan(p, a, n))
    return scores, row_min, row_arg


nqueens_neighborhood_scores.launches = 0
nqueens_neighborhood_scores.shapes = Counter()  # launches per (P, A, n)
