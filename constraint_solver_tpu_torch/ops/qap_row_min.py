"""QAP's swap row minimum (K1): CUDA on the card, plain PyTorch on the CPU.

No Pallas kernel of the JAX package computes it: there the compact and
incremental QAP neighborhoods (``constraint_solver_tpu/models/qap.py:202-224``
and ``:325-341``) leave it to XLA, which fuses the swap deltas and their masked
row min + argmin into one pass over the delta block.  Eager PyTorch runs the
same expression as some ten passes over [P, n, n] floats, so the port has a
kernel for it.  For lane k and facilities a < b:

    w[k, a, b] = cur[k] + 2·((((H[a,b] + H[b,a]) − H[a,a]) − H[b,b]) + (2·F[a,b])·G[a,b])

and w = +inf for b ≤ a; each row's minimum and first argmin over b, as
``torch.min`` takes them (a NaN wins, the first one; ties to the smaller b;
row n−1, all inf, gives (inf, 0)).

- ``qap_swap_row_min(h, g, flow, cur)`` is the wrapper.  It checks device,
  dtype, shape and contiguity in one pass, then takes the plain version for
  tensors on the CPU, and for tensors on a CUDA device launches the kernel in
  ``csrc/qap_row_min.cu`` or raises: there is no fallback.  ``cur`` may be a
  strided view (the score's first column); its stride goes to the kernel.
  ``.launches`` counts its kernel launches and ``.shapes`` them per (P, n),
  through ``ops/launch_count.py``, so CUDA graph replays count too.
- ``qap_swap_row_min_ref`` is the plain version, the port's eager expression
  (``swap_deltas``, the mask, ``torch.min``).  The kernel evaluates the same
  operations in the same order with one rounding each and no contraction, so
  the two are equal bit for bit for any float input, NaN and ±inf included.
- ``build_library`` compiles the kernel with ``nvcc`` into ``build/kernels/``
  at first use, as ``ops/nqueens_kernel.py`` builds B1, and loads it with
  ``ctypes``.  ``_launcher(index)`` also calls the library's
  ``qap_row_min_init`` once per device, on the first call there (outside any
  capture: the solvers run a descent's first iteration eagerly), which sets
  the ring's dynamic shared memory; the launch itself sets no attribute, so a
  CUDA graph captures it.
- ``kernel_work(p, n)`` is one call's work by formula, (operations, bytes),
  which ``utils/roofline.py`` counts for the call whatever computes it.

The launch plan (``_launch_plan``, a pure function of (P, n) and whether the
tables lie on 16 bytes), which the wrapper passes to the C entry as it is:

- ``"ring"`` where n % 4 == 0 and h, g and flow start on 16 bytes: a
  persistent grid of at most two 256-thread blocks per SM walks the (lane,
  strip pair) items lane-fastest, block i taking items i, i + grid, ...; strip
  s is the 32 rows from 32 s, scored against the columns from 32 s to n in
  tiles of 64, and strips x and ⌈n/32⌉ − 1 − x make one item.  Each tile goes
  through a ring of three stages of shared memory, filled by 16-byte
  ``cp.async`` copies two tiles ahead of the one being scored.
- ``"ragged"`` otherwise (a row stride off 16 bytes): the strip loop, a block of
  8 warps for each (strip pair, lane), grid (⌈strips/2⌉, P).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.ops import launch_count
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "qap_row_min.cu"
_LIB_PATH = nk._BUILD_DIR / "libqap_row_min.so"
KERNEL_NAME = "qap_swap_row_min"
_BUILD_LOCK = threading.Lock()  # the lazy build and load of the library, and each device's init
_launch_fn = None
_init_fn = None
_ready_devices: set = set()  # device indices where ``qap_row_min_init`` has run

# The ring's geometry, as ``csrc/qap_row_min.cu`` builds it.
ROWS = 32  # rows of a strip (kT)
COLS = 64  # columns of a tile (kCols)
THREADS = 256  # threads of a ring block (kThreads)
STAGES = 3  # stages of the ring (kStages)
STAGE_FLOATS = 3 * ROWS * COLS + COLS * (ROWS + 4) + COLS + ROWS + 4  # kStageFloats: 8,548
BLOCKS_PER_SM = 2  # ring blocks resident on one SM (``__launch_bounds__``, shared memory)


class LaunchPlan(NamedTuple):
    path: str  # "ring" (16-byte cp.async into a ring of stages) or "ragged" (the strip loop)
    grid: tuple[int, int]
    block: tuple[int, int]
    stages: int  # stages of the ring; 0 on the ragged path
    smem_bytes: int  # dynamic shared memory a block; 0 on the ragged path (static)


@functools.lru_cache(maxsize=64)
def _launch_plan(p: int, n: int, aligned: bool = True) -> LaunchPlan:
    """K1's launch for P lanes of n facilities (P, n ≥ 1); ``aligned``: h, g
    and flow start on 16 bytes."""
    pairs = (-(-n // ROWS) + 1) // 2  # strips x and ⌈n/32⌉ − 1 − x
    if n % 4 == 0 and aligned:  # a persistent grid over the p · pairs items
        return LaunchPlan("ring", (min(p * pairs, BLOCKS_PER_SM * nk._SMS), 1), (THREADS, 1), STAGES,
                          4 * STAGES * STAGE_FLOATS)
    return LaunchPlan("ragged", (pairs, p), (32, 8), 0, 0)


def build_library(force: bool = False) -> str:
    """Compile ``csrc/qap_row_min.cu`` into ``build/kernels/`` if the library is
    missing, older than its source, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    with _BUILD_LOCK:
        return nk.compile_library(_SRC, _LIB_PATH, force)


def _launcher(index: int | None = None):
    """The C entry ``qap_row_min_launch``, built and resolved once; with a
    device ``index``, after ``qap_row_min_init`` has run on that device."""
    global _launch_fn, _init_fn
    if _launch_fn is None:
        with _BUILD_LOCK:
            if _launch_fn is None:
                nk.compile_library(_SRC, _LIB_PATH, force=False)
                lib = ctypes.CDLL(str(_LIB_PATH))
                init = lib.qap_row_min_init
                init.argtypes = []
                init.restype = ctypes.c_int
                fn = lib.qap_row_min_launch
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [
                    ctypes.c_int] * 9 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _init_fn = init
                _launch_fn = fn
    if index is not None and index not in _ready_devices:
        with _BUILD_LOCK:
            if index not in _ready_devices:
                with torch.cuda.device(index):
                    err = _init_fn()
                if err != 0:
                    raise RuntimeError(f"qap_row_min_init failed: cudaError_t {err} on cuda:{index}")
                _ready_devices.add(index)
    return _launch_fn


def kernel_work(p: int, n: int) -> tuple[int, int]:
    """(operations, bytes) of one call.  Operations: 9 float32 operations per
    swap a < b (the eight of w and one comparison).  Bytes: the whole of H
    (row a's entries and, as the transposed term, column a's), the strict
    upper triangles of G and F and cur read once, rmin (4 bytes) and rarg (8)
    written once."""
    pairs = n * (n - 1) // 2
    return 9 * p * pairs, 4 * (p * n * n + p * pairs + pairs + p) + 12 * p * n


def check_inputs(h, g, flow, cur) -> tuple[int, int]:
    if h.dim() != 3:
        raise ValueError(f"h must be [P, n, n], got {tuple(h.shape)}")
    p, n = h.shape[0], h.shape[1]
    device = h.device
    for name, t, shape in (("h", h, (p, n, n)), ("g", g, (p, n, n)), ("flow", flow, (n, n))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.shape != shape or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous with shape {shape} on {device}, got shape {tuple(t.shape)} on "
                f"{t.device}, contiguous={t.is_contiguous()}"
            )
    if cur.dtype != torch.float32:
        raise TypeError(f"cur must be torch.float32, got {cur.dtype}")
    if cur.shape != (p,) or cur.device != device:  # any stride: the kernel takes it
        raise ValueError(f"cur must have shape {(p,)} on {device}, got {tuple(cur.shape)} on {cur.device}")
    return p, n


def swap_deltas(h, g, flow):
    """delta[k, a, b] of every swap, float32[P, n, n] (F and G symmetric, so
    H's transpose is (F G)ᵀ = G F)."""
    hd = torch.diagonal(h, dim1=1, dim2=2)
    return 2.0 * (h + h.transpose(1, 2) - hd[:, :, None] - hd[:, None, :] + 2.0 * flow * g)


def qap_swap_row_min_ref(h, g, flow, cur):
    """Plain PyTorch version.  Returns (rmin float32[P, n], rarg int64[P, n])."""
    n = h.shape[1]
    iota = torch.arange(n, device=h.device)
    upper = iota[:, None] < iota[None, :]
    w = torch.where(upper, cur[:, None, None] + swap_deltas(h, g, flow), torch.inf)
    rmin, rarg = torch.min(w, dim=2)  # first index on ties
    return rmin, rarg


def _launch(h, g, flow, cur, rmin, rarg, p: int, n: int) -> None:
    """Launch the kernel on the tensors' device and its current stream, by
    ``_launch_plan``."""
    index = h.device.index
    fn = _launcher(index)
    hp, gp, fp = h.data_ptr(), g.data_ptr(), flow.data_ptr()
    plan = _launch_plan(p, n, (hp | gp | fp) % 16 == 0)
    (gx, gy), (bx, by) = plan.grid, plan.block
    args = (hp, gp, fp, cur.data_ptr(), cur.stride(0), rmin.data_ptr(), rarg.data_ptr(), p, n, plan.path == "ring",
            gx, gy, bx, by, plan.stages, plan.smem_bytes)
    if index == torch.cuda.current_device():  # as in ``nqueens_kernel._launch``: no device guard to pay for
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"qap_row_min_launch failed: cudaError_t {err} at (P, n) = {(p, n)} for {plan}")
    launch_count.count(qap_swap_row_min, (p, n))


def qap_swap_row_min(h, g, flow, cur):
    """Each row's best swap partner b > a.  Inputs: h, g float32[P, n, n] and
    flow float32[n, n], contiguous; cur float32[P]; all on one device.
    Returns (rmin float32[P, n], rarg int64[P, n])."""
    p, n = check_inputs(h, g, flow, cur)
    count = roofline.active_count()
    if count is not None:
        # Counted by formula; the ops issued below are not counted.
        with count.kernel(KERNEL_NAME, *kernel_work(p, n)):
            return _row_min(h, g, flow, cur, p, n)
    return _row_min(h, g, flow, cur, p, n)


def _row_min(h, g, flow, cur, p: int, n: int):
    device = h.device
    if device.type == "cpu":
        return qap_swap_row_min_ref(h, g, flow, cur)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if p > nk._MAX_LANES:  # the ragged grid's y dimension; the ring takes the same bound
        raise ValueError(f"at most {nk._MAX_LANES} lanes per launch, got {p}")
    rmin = h.new_empty((p, n))
    rarg = torch.empty((p, n), dtype=torch.int64, device=device)
    if p * n:
        _launch(h, g, flow, cur, rmin, rarg, p, n)
    return rmin, rarg


launch_count.counted(qap_swap_row_min)  # .launches, and .shapes per (P, n)
