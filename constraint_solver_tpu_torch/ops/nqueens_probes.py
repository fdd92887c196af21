"""The five N-Queens probe kernels of ``bench/kernel_iso.py``: CUDA on the card, plain PyTorch on the CPU.

Port of the per-call ``run`` of ``build(kern, ...)`` and ``build_packed()``
(``bench/kernel_iso.py:194-291``).  Each probe computes N-Queens' candidate
block (``ops/nqueens_kernel.py``) over n_pad = ⌈n/128⌉·128 columns from tables
zero-padded to n_pad (rc) and 2·n_pad (dc, ac), in its own table format:

- ``kern_base`` (B2a, ``_kern_base``): float32 tables, the windows
  dc[i + n−1−c_j] and ac[i + c_j];
- ``kern_noroll`` (B2b, ``_kern_noroll``): float32 tables at the fixed windows
  dc[i] and ac[n_pad + i], plus c_j·0 — wrong by design, it times everything but
  the column-dependent window start;
- ``kern_i16`` (B2c, ``_kern_i16``): int16 tables, the three terms summed in
  int16 and cast to float32;
- ``kern_i16min`` (B2d, ``_kern_i16min``): B2c plus each row's min and first
  argmin over the n valid columns;
- ``kern_packed`` (B2e, ``_kern_packed``): float32 rc and one int32 table
  ``dac`` = dc in the low 16 bits | ac reversed in the high 16 bits
  (ac_rev[t] = ac[n + n_pad − 2 − t] where that index lies in [0, 2n−2], else
  0), read forward from o = n−1−c_j for dc and backward from o + n_pad − 1 for
  ac; B2d's outputs.

Every value is a small integer, so the probes and their plain versions are
exact and equal the TPU kernels bit for bit, padding columns included.

- Each wrapper takes the N-Queens kernel's batched inputs — rc float32[P, n],
  dc/ac float32[P, 2n−1], c/r int32[P, A], removed float32[P, A], cur
  float32[P], c in [0, n) — prepares its tables in plain PyTorch
  (``prepare_tables``), and returns the TPU kernel's outputs with a leading P:
  ``(scores float32[P, A, n_pad],)``, or with ``row_min`` float32[P, A] and
  ``row_arg`` int32[P, A] for B2d and B2e.  On CPU tensors it computes the plain
  version (``kern_*_ref``); on CUDA tensors it launches its kernel in
  ``csrc/nqueens_probes.cu`` or raises: there is no fallback.  ``.launches``
  counts its kernel launches.
- ``launch_plan(name, p, a, n)`` is each kernel's launch, a pure function: B1's
  grid of (⌈A/G⌉, P) blocks of G warps, one sampled column each; the lane's
  tables staged in shared memory where their format fits the 227 KB a block may
  use (float32 up to n_pad = 11,520, packed 19,328, int16 23,168), else read
  from global memory.
- ``probe_work(name, p, a, n)`` is one call's (operations, bytes) by formula, for
  ``utils/roofline.py`` and the bounds in ``chip_smoke.py``.

Divergences from the TPU kernels: one call covers all P lanes (the JAX harness
calls each per lane under ``vmap``), and ``cur`` is float32[P].
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "nqueens_probes.cu"
_LIB_PATH = nk._BUILD_DIR / "libnqueens_probes.so"
ROW_ALIGN = 128  # the TPU harness pads n to its lane width; csrc kRowAlign
INT16_MAX_N = 32_767  # every count fits int16 (and a 16-bit half of dac) up to this n
_BUILD_LOCK = threading.Lock()  # the lazy build and load of the library
_launch_fns: dict | None = None


class Probe(NamedTuple):
    table: str  # "f32", "i16" or "packed": the tables' format in device and shared memory
    fixed_windows: bool  # the noroll probe's static windows
    with_min: bool  # also each row's min and first argmin
    entry: str  # the C entry in csrc/nqueens_probes.cu
    event: str  # in the kernel's name in a profiler trace
    body_line: int  # the TPU kernel's body in bench/kernel_iso.py


PROBES = {
    "kern_base": Probe("f32", False, False, "probe_base_launch", "probe_base_kernel", 61),
    "kern_noroll": Probe("f32", True, False, "probe_noroll_launch", "probe_noroll_kernel", 82),
    "kern_i16": Probe("i16", False, False, "probe_i16_launch", "probe_i16_kernel", 103),
    "kern_i16min": Probe("i16", False, True, "probe_i16min_launch", "probe_i16min_kernel", 126),
    "kern_packed": Probe("packed", False, True, "probe_packed_launch", "probe_packed_kernel", 157),
}
_TABLE_BYTES_PER_ROW = {"f32": 4 * 5, "i16": 2 * 5, "packed": 4 + 4 * 2}  # rc [n_pad] + dc, ac [2·n_pad]


def padded(n: int) -> int:
    return -(-n // ROW_ALIGN) * ROW_ALIGN


def table_bytes(table: str, n_pad: int) -> int:
    """Bytes of one lane's tables in ``table``'s format (csrc ``table_bytes``)."""
    return _TABLE_BYTES_PER_ROW[table] * n_pad


def probe_work(name: str, p: int, a: int, n: int) -> tuple[int, int]:
    """(operations, bytes) of one call.  Operations per score: 8 to form it
    (three subtractions of the own-row term, two additions, the removed term,
    the doubling, the current total), +1 comparison for the row min, +2 for the
    noroll probe's c·0.  Bytes: the tables in the probe's format, c, r, removed
    and cur read once; the float32 scores [A, n_pad], and the row min and
    argmin where the probe has them, written once."""
    probe = PROBES[name]
    n_pad = padded(n)
    per_score = 8 + probe.with_min + 2 * probe.fixed_windows
    per_lane = 4 * a * n_pad + table_bytes(probe.table, n_pad) + 4 * (3 * a + 1) + (8 * a if probe.with_min else 0)
    return per_score * p * a * n_pad, p * per_lane


class ProbePlan(NamedTuple):
    cols_per_block: int  # G: warps per block, one sampled column each
    grid: tuple[int, int]  # (⌈A/G⌉, P)
    smem_bytes: int  # dynamic shared memory per block; 0 unless staged
    staged: bool  # the lane's tables in shared memory, else read from global memory


@functools.lru_cache(maxsize=64)
def launch_plan(name: str, p: int, a: int, n: int) -> ProbePlan:
    """Kernel ``name``'s launch for P lanes, A sampled columns and n rows (P, A ≥ 1).
    G follows B1's rule (at most 8); the kernels take up to 32 (csrc kMaxWarps)."""
    g = nk.columns_per_block(p, a)
    smem = table_bytes(PROBES[name].table, padded(n))
    staged = smem <= nk._SMEM_LIMIT
    return ProbePlan(g, (-(-a // g), p), smem if staged else 0, staged)


def prepare_tables(table: str, rc, dc, ac) -> tuple:
    """The tables in ``table``'s format, zero-padded (``kernel_iso.py``
    ``run``): (rc [P, n_pad], dc [P, 2·n_pad], ac [P, 2·n_pad]) in float32 or
    int16, or (rc float32 [P, n_pad], dac int32 [P, 2·n_pad])."""
    p, n = rc.shape
    n_pad = padded(n)
    if table == "packed":
        rc_p = rc.new_zeros((p, n_pad))
        rc_p[:, :n] = rc
        i32 = torch.int32
        dc_i = torch.zeros((p, 2 * n_pad), dtype=i32, device=rc.device)
        dc_i[:, : 2 * n - 1] = dc
        src = (n + n_pad - 2) - torch.arange(2 * n_pad, device=rc.device)
        ok = (src >= 0) & (src <= 2 * n - 2)
        ac_rev = torch.where(ok, ac.to(i32)[:, src.clamp(0, 2 * n - 2)], 0)
        return rc_p, dc_i | (ac_rev << 16)
    dtype = torch.float32 if table == "f32" else torch.int16
    out = []
    for t, length in ((rc, n_pad), (dc, 2 * n_pad), (ac, 2 * n_pad)):
        z = torch.zeros((p, length), dtype=dtype, device=rc.device)
        z[:, : t.shape[1]] = t
        out.append(z)
    return tuple(out)


def _ref(name: str, rc, dc, ac, c, r, removed, cur) -> tuple:
    probe = PROBES[name]
    p, n = rc.shape
    a = c.shape[1]
    n_pad = padded(n)
    tables = prepare_tables(probe.table, rc, dc, ac)
    rp = torch.arange(n_pad, device=rc.device)
    c64 = c.long()

    def window(table, start):  # table[p, start[p, j] + i] for i < n_pad
        return table.gather(1, start.unsqueeze(-1).add(rp).reshape(p, a * n_pad)).view(p, a, n_pad)

    if probe.table == "packed":
        rc_p, dac = tables
        w = window(dac, (n - 1) - c64)
        dc_at, ac_at = (w & 0xFFFF).float(), (w >> 16).flip(-1).float()
    elif probe.fixed_windows:
        rc_p, dc_p, ac_p = tables
        dc_at, ac_at = dc_p[:, None, :n_pad], ac_p[:, None, n_pad:]
    else:
        rc_p, dc_p, ac_p = tables
        dc_at, ac_at = window(dc_p, (n - 1) - c64), window(ac_p, c64)
    same = (rp == r.long().unsqueeze(-1)).to(rc_p.dtype)
    added = (rc_p.unsqueeze(1) - same) + (dc_at - same) + (ac_at - same)  # int16 sums wrap as on the TPU
    scores = cur[:, None, None] + 2.0 * (added.float() - removed.unsqueeze(-1))
    if probe.fixed_windows:
        scores = scores + c.float().unsqueeze(-1) * 0.0
    if not probe.with_min:
        return (scores,)
    masked = scores.masked_fill(rp >= n, float("inf"))
    return scores, masked.amin(dim=-1), masked.argmin(dim=-1).to(torch.int32)


def _launchers() -> dict:
    """The five C entries, built and resolved once."""
    global _launch_fns
    if _launch_fns is None:
        with _BUILD_LOCK:
            if _launch_fns is None:
                nk.compile_library(_SRC, _LIB_PATH, force=False)
                lib = ctypes.CDLL(str(_LIB_PATH))
                fns = {}
                for name, probe in PROBES.items():
                    fn = getattr(lib, probe.entry)
                    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    fns[name] = fn
                _launch_fns = fns
    return _launch_fns


def build_library(force: bool = False) -> str:
    """Compile ``csrc/nqueens_probes.cu`` into ``build/kernels/`` if the library
    is missing, older than its source, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    with _BUILD_LOCK:
        return nk.compile_library(_SRC, _LIB_PATH, force)


def _launch(name: str, tables: tuple, c, r, removed, cur, outs: tuple, p: int, a: int, n: int,
            plan: ProbePlan) -> None:
    """Launch kernel ``name`` on the tensors' device and its current stream."""
    fn = _launchers()[name]
    index = c.device.index
    ac = tables[2].data_ptr() if len(tables) == 3 else None
    row_min, row_arg = (outs[1].data_ptr(), outs[2].data_ptr()) if len(outs) == 3 else (None, None)
    ptrs = (tables[0].data_ptr(), tables[1].data_ptr(), ac, c.data_ptr(), r.data_ptr(), removed.data_ptr(),
            cur.data_ptr(), outs[0].data_ptr(), row_min, row_arg)
    g, (grid_x, _), smem, staged = plan
    args = (*ptrs, p, a, n, padded(n), g, grid_x, smem, staged)
    if index == torch.cuda.current_device():  # as in ``nqueens_kernel._launch``: no device guard to pay for
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{PROBES[name].entry} failed: cudaError_t {err} for {plan}")
    WRAPPERS[name].launches += 1


def _call(name: str, rc, dc, ac, c, r, removed, cur) -> tuple:
    p, a, n = nk.check_inputs(rc, dc, ac, c, r, removed, cur)
    probe = PROBES[name]
    if probe.table != "f32" and n > INT16_MAX_N:
        raise ValueError(f"{name} holds counts in 16 bits: n must be at most {INT16_MAX_N}, got {n}")
    count = roofline.active_count()
    if count is not None:
        # Counted by formula; the ops issued below are not counted.
        with count.kernel(name, *probe_work(name, p, a, n)):
            return _compute(name, rc, dc, ac, c, r, removed, cur, p, a, n)
    return _compute(name, rc, dc, ac, c, r, removed, cur, p, a, n)


def _compute(name: str, rc, dc, ac, c, r, removed, cur, p: int, a: int, n: int) -> tuple:
    device = rc.device
    if device.type == "cpu":
        return _ref(name, rc, dc, ac, c, r, removed, cur)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if p > nk._MAX_LANES:
        raise ValueError(f"at most {nk._MAX_LANES} lanes per launch, got {p}")
    tables = prepare_tables(PROBES[name].table, rc, dc, ac)
    scores = rc.new_empty((p, a, padded(n)))
    outs = (scores, rc.new_empty((p, a)), c.new_empty((p, a))) if PROBES[name].with_min else (scores,)
    if p * a:
        _launch(name, tables, c, r, removed, cur, outs, p, a, n, launch_plan(name, p, a, n))
    return outs


def kern_base(rc, dc, ac, c, r, removed, cur):
    """B2a, ``bench/kernel_iso.py`` ``_kern_base``: (scores float32[P, A, n_pad],)."""
    return _call("kern_base", rc, dc, ac, c, r, removed, cur)


def kern_base_ref(rc, dc, ac, c, r, removed, cur):
    """Plain PyTorch version of ``kern_base``."""
    return _ref("kern_base", rc, dc, ac, c, r, removed, cur)


def kern_noroll(rc, dc, ac, c, r, removed, cur):
    """B2b, ``_kern_noroll``: (scores float32[P, A, n_pad],), wrong by design."""
    return _call("kern_noroll", rc, dc, ac, c, r, removed, cur)


def kern_noroll_ref(rc, dc, ac, c, r, removed, cur):
    """Plain PyTorch version of ``kern_noroll``."""
    return _ref("kern_noroll", rc, dc, ac, c, r, removed, cur)


def kern_i16(rc, dc, ac, c, r, removed, cur):
    """B2c, ``_kern_i16``: (scores float32[P, A, n_pad],) from int16 tables."""
    return _call("kern_i16", rc, dc, ac, c, r, removed, cur)


def kern_i16_ref(rc, dc, ac, c, r, removed, cur):
    """Plain PyTorch version of ``kern_i16``."""
    return _ref("kern_i16", rc, dc, ac, c, r, removed, cur)


def kern_i16min(rc, dc, ac, c, r, removed, cur):
    """B2d, ``_kern_i16min``: (scores float32[P, A, n_pad], row_min float32[P, A],
    row_arg int32[P, A]) from int16 tables."""
    return _call("kern_i16min", rc, dc, ac, c, r, removed, cur)


def kern_i16min_ref(rc, dc, ac, c, r, removed, cur):
    """Plain PyTorch version of ``kern_i16min``."""
    return _ref("kern_i16min", rc, dc, ac, c, r, removed, cur)


def kern_packed(rc, dc, ac, c, r, removed, cur):
    """B2e, ``_kern_packed``: B2d's outputs from float32 rc and the packed dac."""
    return _call("kern_packed", rc, dc, ac, c, r, removed, cur)


def kern_packed_ref(rc, dc, ac, c, r, removed, cur):
    """Plain PyTorch version of ``kern_packed``."""
    return _ref("kern_packed", rc, dc, ac, c, r, removed, cur)


WRAPPERS = {"kern_base": kern_base, "kern_noroll": kern_noroll, "kern_i16": kern_i16,
            "kern_i16min": kern_i16min, "kern_packed": kern_packed}
REFS = {"kern_base": kern_base_ref, "kern_noroll": kern_noroll_ref, "kern_i16": kern_i16_ref,
        "kern_i16min": kern_i16min_ref, "kern_packed": kern_packed_ref}
for _fn in WRAPPERS.values():
    _fn.launches = 0
