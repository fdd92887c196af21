"""K5, the roster's dense neighborhood: CUDA on the card, plain PyTorch on the CPU.

The scheduling problem's dense proposer (``models/scheduling.py``) scores, for
each lane's assignment a int64[P, D] of employees 0..E-1 to days, W = D·E + R
+ O·D candidates in one call: every ChangeDay move (day d to employee e, index
d·E + e), R random swaps (days ``rs_d1`` and ``(rs_d1 + rs_off) mod D``) and O
swap diagonals (days d and d + ``delta[j]``, slot D·E + R + j·D + d; invalid
where d + δ >= D, with d2 clamped to D - 1), each delta exact.  In the JAX
package XLA fuses that into a few passes of the jitted descent
(``constraint_solver_tpu/models/scheduling.py:594-884`` ``neighborhood_dense``);
eager PyTorch runs it as about 770 kernels a call.  ``sched_dense(assign, cur_score,
tables, start_weekday, rs_d1, rs_off, delta)`` returns a ``DenseOut``: the
scores float32[P, W, 2] (``cur_score`` plus each delta), ``valid`` bool[P, W],
``fp_deltas`` int64[P, W, 2] (uint32 values) and the moves ``is_swap`` bool,
``d1``, ``d2``, ``new_emp`` int64[P, W].

- ``sched_dense`` is the wrapper.  It checks dtypes, shapes, devices and
  strides (the assignment with unit stride along D, the holiday table
  contiguous; ``cur_score`` and the draws any strides), takes the plain version
  for tensors on the CPU, and for tensors on a CUDA device launches the
  kernel in ``csrc/sched_dense.cu`` or raises: there is no fallback, and a
  shape the kernel does not take (D above ``MAX_DAYS``, E above ``MAX_EMPS``)
  raises on the card.  One launch a call: ``sched_dense.launches`` counts it
  and ``.shapes`` counts it per (P, D, E, R, O), through
  ``ops/launch_count.py``, so CUDA graph replays count too.  Every employee of
  ``assign`` must lie in [0, E), as the solvers' do.
- ``sched_dense_ref`` is the plain version: the eager chain the dense proposer
  ran before K5, bit for bit (one-hot planes, banded window matmuls, the
  first / second minimum tricks, ``exact_move_deltas`` for the random swaps,
  K2a for the fingerprints, the blocks concatenated).
- ``_launch_plan(p, d, e, n_rand, n_off, sms)`` is the launch (its design is
  in the source), a pure function of the shapes and the card's SM count: a
  lane is one thread-block cluster of S blocks of ``THREADS`` threads, S as
  many as fit the card in one wave (P·S at most ``WAVE_FILL`` of
  ``BLOCKS_PER_SM`` blocks on each SM), at most ``MAX_SLICES`` and at most D
  (grid P·S); block r owns the days [D·r/S, D·(r+1)/S), at most ``span`` =
  ⌈D/S⌉, takes ``chunk`` = min(span, ``MAX_CHUNK``) days at a time and its
  random swaps ``swap_batch`` at a time, with ``smem`` bytes of dynamic
  shared memory (``_smem_bytes``, laid out as the source's ``layout``).  In
  shared memory while a block stays within ``SMEM_MAX``: the lane's window
  flags (``flags_shared``), then the block's (hard, S1) plane that the
  diagonals read across the cluster (``plane_shared``), then its holiday rows
  (``hol_shared``); the wrapper allocates a global scratch for the flags or
  the plane that does not fit (both at 4096 x 256).  At (64, 365, 20, 256,
  4): S = 7, spans of 53 days, 448 blocks of 17,968 bytes, everything in
  shared memory; at (128, 730, 40, 256, 4): S = 3, 384 blocks of 93,568
  bytes.
- ``occupancy(p, d, e, n_rand, n_off, device)`` is the plan with what the card
  makes of it (registers, blocks an SM, clusters at once), for a log.
- ``kernel_work(p, d, e, n_rand, n_off)`` is one call's (operations, bytes) by
  formula: what ``utils/roofline.py`` counts for the call.
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
from constraint_solver_tpu_torch.ops.block_pick import _sms
from constraint_solver_tpu_torch.ops.fingerprint import hash_xor
from constraint_solver_tpu_torch.utils import roofline

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "sched_dense.cu"
_LIB_PATH = nk._BUILD_DIR / "libsched_dense.so"
KERNEL_NAME = "sched_dense"
_ARGS = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]  # (const long long* plan, void* stream)
_OCCUPANCY_ARGS = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]  # (plan, int out[4])
_LIBRARY = nk.KernelLibrary(_SRC, _LIB_PATH, {"sched_dense_launch": _ARGS, "sched_dense_occupancy": _OCCUPANCY_ARGS})
THREADS = 256  # threads of a block (csrc kThreads)
MAX_DAYS = 4096  # D: the lane's assignment in shared memory (csrc kMaxDays)
MAX_EMPS = 256  # E (csrc kMaxEmps)
MAX_SLICES = 8  # blocks a lane, one thread-block cluster: the portable size (csrc kMaxSlices)
MAX_CHUNK = 128  # days of a chunk: its per-day fields (csrc kMaxChunk)
SMEM_MAX = 232_448  # dynamic shared memory a block may have, 227 KB (csrc kSmemMax)
BLOCKS_PER_SM = 4  # blocks of THREADS an SM holds: the kernel's registers leave room for 4 (csrc kMinBlocks)
WAVE_FILL = 0.9  # the share of P·S ≤ BLOCKS_PER_SM·SMs blocks that clusters of S pack onto the card at once
PLAN_LEN = 40  # int64 entries of the plan (csrc kPlanLen)
LIST_WORDS = 33  # the lists and their counts (csrc kListWords)
DAY_FIELDS = 18  # int fields a day of a chunk (csrc kDayFields)
HASH_FIELDS = 4  # uint32 hash terms a day of a block (csrc kHashFields)
SWAP_FIELDS = 4  # int fields a random swap of a batch (csrc kSwapFields)
FLAGS = 4  # window flag rows an employee (csrc kFlags)
CELL_OPS = 100  # integer operations a ChangeDay cell, about (window and row terms)
SWAP_OPS = 1200  # a random swap's window terms, about (and 3 an employee for its rows)
DIAG_OPS = 40  # a diagonal slot's, about (and 3 an employee for its rows)
OUT_BYTES = 50  # bytes a candidate writes: scores 8, fingerprints 16, valid 1, the moves 1 + 3·8


class DenseOut(NamedTuple):
    scores: torch.Tensor     # float32[P, W, 2]
    valid: torch.Tensor      # bool[P, W]
    fp_deltas: torch.Tensor  # int64[P, W, 2]
    is_swap: torch.Tensor    # bool[P, W]
    d1: torch.Tensor         # int64[P, W]
    d2: torch.Tensor
    new_emp: torch.Tensor


class LaunchPlan(NamedTuple):
    slices: int  # S: blocks a lane, one thread-block cluster; block r owns days [D·r/S, D·(r+1)/S)
    span: int  # days a block owns at most, ⌈D/S⌉
    chunk: int  # days a block takes at a time, min(span, MAX_CHUNK)
    swap_batch: int  # random swaps a block takes at a time, min(THREADS, ⌈R/S⌉)
    smem: int  # dynamic shared memory bytes a block
    flags_shared: bool  # the lane's window flags in every block's shared memory, else in a global scratch
    plane_shared: bool  # the blocks' (hard, S1) planes in shared memory, else in a global scratch
    hol_shared: bool  # the block's holiday rows copied into its shared memory, else read from global memory
    grid: int  # blocks: P·S, one launch


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def _smem_bytes(d: int, e: int, slices: int, chunk: int, span: int, n_off: int, batch: int, flags: bool,
                hol: bool, plane: bool) -> int:
    """A block's dynamic shared memory (csrc ``layout``): the assignment
    int16[D], the block's membership words uint32[E][⌈N/S⌉ + 1] (N = ⌈D/32⌉),
    the counts int[7][E], the totals and weekend totals, the lists,
    ``DAY_FIELDS`` ints a day of the chunk, ``HASH_FIELDS`` a day of the span,
    the O offsets, ``SWAP_FIELDS`` ints a swap of a batch; with ``flags`` the
    lane's window flags uint32[4][E][N + 2], with ``plane`` the block's (hard,
    S1) plane int8[span][E][2], with ``hol`` its holiday rows float32[span][E]."""
    nw = -(-d // 32)
    sizes = (2 * d, 4 * e * (-(-nw // slices) + 1), 4 * 7 * e, 4 * e, 4 * e, 4 * LIST_WORDS, 4 * DAY_FIELDS * chunk,
             4 * HASH_FIELDS * span, 4 * n_off, 4 * SWAP_FIELDS * batch, 16 * e * (nw + 2) if flags else 0,
             2 * span * e if plane else 0, 4 * span * e if hol else 0)
    return sum(_align16(x) for x in sizes)


@functools.lru_cache(maxsize=64)
def _launch_plan(p: int, d: int, e: int, n_rand: int, n_off: int, sms: int) -> LaunchPlan:
    """K5's launch for P lanes of D days and E employees with R random swaps
    and O diagonals on a card of ``sms`` SMs (D <= ``MAX_DAYS``, E <=
    ``MAX_EMPS``): S blocks a lane, as many as fit the card in one wave
    (P·S at most ``WAVE_FILL`` of ``BLOCKS_PER_SM`` blocks on each SM), at
    most ``MAX_SLICES`` and at most D; in shared memory, while a block stays
    within ``SMEM_MAX``: the window flags, then the plane, then the holiday
    rows."""
    slices = max(1, min(MAX_SLICES, d, int(WAVE_FILL * BLOCKS_PER_SM * sms) // p))
    span = -(-d // slices)
    chunk = min(span, MAX_CHUNK)
    batch = min(THREADS, -(-n_rand // slices))
    fits = functools.partial(_smem_bytes, d, e, slices, chunk, span, n_off, batch)
    flags = fits(True, False, False) <= SMEM_MAX
    plane = fits(flags, False, True) <= SMEM_MAX
    hol = fits(flags, True, plane) <= SMEM_MAX
    return LaunchPlan(slices, span, chunk, batch, fits(flags, hol, plane), flags, plane, hol, p * slices)


def kernel_work(p: int, d: int, e: int, n_rand: int, n_off: int) -> tuple[int, int]:
    """(operations, bytes) of one call.  Bytes: the assignment, ``cur_score``,
    the holiday table and the draws read once, and ``OUT_BYTES`` written a
    candidate (what the function must move; the [P, D, E, 2] int8 scratch
    of the diagonals, where the plan has one, is not counted).  Operations:
    about ``CELL_OPS`` a ChangeDay cell, ``SWAP_OPS`` + 3·E a random swap and
    ``DIAG_OPS`` + 3·E a diagonal slot, integer operations of the kernel's
    loops; they take a tenth of the bytes' time."""
    width = d * e + n_rand + n_off * d
    nbytes = 8 * p * d + 8 * p + 4 * d * e + 16 * p * n_rand + 8 * p * n_off + OUT_BYTES * p * width
    ops = p * (CELL_OPS * d * e + (SWAP_OPS + 3 * e) * n_rand + (DIAG_OPS + 3 * e) * n_off * d)
    return ops, nbytes


def check_inputs(assign, cur_score, tables, start_weekday, rs_d1, rs_off, delta) -> tuple[int, ...]:
    """(P, D, E, R, O) of a call, or a raise."""
    if assign.dim() != 2:
        raise ValueError(f"assign must be [P, D], got {tuple(assign.shape)}")
    p, d = assign.shape
    holiday = tables.holiday_de
    if holiday.dim() != 2 or holiday.shape[0] != d or holiday.shape[1] < 1 or d < 1:
        raise ValueError(f"the holiday table must be [D, E] = [{d}, E >= 1] with D >= 1, got "
                         f"{tuple(holiday.shape)}")
    e = holiday.shape[1]
    if rs_d1.dim() != 2 or delta.dim() != 2:
        raise ValueError(f"the draws must be [P, R] and [P, O], got {tuple(rs_d1.shape)} and "
                         f"{tuple(delta.shape)}")
    n_rand, n_off = rs_d1.shape[1], delta.shape[1]
    if not 0 <= start_weekday <= 6:
        raise ValueError(f"start_weekday must be 0 to 6, got {start_weekday}")
    device = assign.device
    f32, i64 = torch.float32, torch.int64
    for name, t, dtype, shape in (("assign", assign, i64, (p, d)), ("cur_score", cur_score, f32, (p, 2)),
                                  ("holiday", holiday, f32, (d, e)), ("rs_d1", rs_d1, i64, (p, n_rand)),
                                  ("rs_off", rs_off, i64, (p, n_rand)), ("delta", delta, i64, (p, n_off))):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape or t.device != device:
            raise ValueError(f"{name} must have shape {shape} on {device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if (d > 1 and assign.stride(1) != 1) or not holiday.is_contiguous():
        raise ValueError(f"assign must have unit stride along D and the holiday table must be contiguous, "
                         f"got strides {assign.stride()} and {holiday.stride()}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return p, d, e, n_rand, n_off


def sched_dense_ref(assign, cur_score, tables, start_weekday, rs_d1, rs_off, delta) -> DenseOut:
    """Plain version: the dense proposer's eager chain.  ``tables`` holds the
    problem's per-device tables (``models/scheduling.py`` ``_Tables``);
    ``start_weekday`` is read there, through ``tables.weekday``."""
    from constraint_solver_tpu_torch.models import scheduling as sm  # the model's shared tensor helpers

    t = tables
    f32 = torch.float32
    a = assign
    p, d_days = a.shape
    n_emp = t.holiday_de.shape[1]
    n_rand, n_off = rs_d1.shape[1], delta.shape[1]
    dev = a.device
    oh = sm._one_hot(a, n_emp)  # [P, D, E]
    iota_d = torch.arange(d_days, device=dev)
    iota_e = torch.arange(n_emp, device=dev)

    # H1: holiday row minus the current day's holiday flag.
    h1_old = (t.holiday_de * oh).sum(-1)
    d_h1 = t.holiday_de - h1_old[..., None]

    # H2: the two adjacent pairs of each day.
    a_l, a_r = sm._shf(a, -1, -2, 1), sm._shf(a, 1, -3, 1)
    m_l = (iota_d >= 1).to(f32)
    m_r = (iota_d <= d_days - 2).to(f32)
    old2 = m_l * (a_l == a) + m_r * (a == a_r)
    new2 = m_l[:, None] * (a_l[..., None] == iota_e) + m_r[:, None] * (a_r[..., None] == iota_e)
    d_h2 = new2 - old2[..., None]

    # H3: the four windows where day d sits at position 0/1/7/8.
    cond = t.weekend & sm._shf(t.weekend, 1, False, 0)
    pairs = ((0, 7), (0, 8), (1, 7), (1, 8))

    def eq(i, j):
        return (sm._shf(a, i, -2, 1) == sm._shf(a, j, -3, 1)).to(f32)

    old3 = eq(0, 7) + eq(0, 8) + eq(1, 7) + eq(1, 8)
    d_h3 = oh.new_zeros((p, d_days, n_emp))
    for q in (0, 1, 7, 8):
        m_q = ((iota_d >= q) & (iota_d <= d_days - 9 + q)).to(f32) * sm._shf(cond, -q, False, 0)
        new_q = oh.new_zeros((p, d_days, n_emp))
        for i, j in pairs:
            if i == q:
                new_q += (sm._shf(a, j - q, -2, 1)[..., None] == iota_e).to(f32)
            elif j == q:
                new_q += (sm._shf(a, i - q, -2, 1)[..., None] == iota_e).to(f32)
            else:
                new_q += (sm._shf(a, i - q, -2, 1) == sm._shf(a, j - q, -3, 1)).to(f32)[..., None]
        d_h3 += m_q[:, None] * (new_q - sm._shf(old3, -q, 0.0, 1)[..., None])

    # H4/S1: +1 on employee e flips a window iff its count is at the
    # threshold; -1 on the old employee iff one above.  The banded
    # matmuls count each window and sum the flips over the windows
    # containing each day.
    def crossings(band, thresh):
        if band.shape[0] == 0:
            z = oh.new_zeros((p, d_days, n_emp))
            return z, z
        cnt = band @ oh  # [P, D-width+1, E]
        return band.T @ (cnt == thresh).to(f32), band.T @ (cnt == thresh + 1).to(f32)

    sp14, sm14 = crossings(t.band14, 3)
    sp7, sm7 = crossings(t.band7, 2)
    d_h4 = sp14 - (sm14 * oh).sum(-1)[..., None]
    d_s1 = sp7 - (sm7 * oh).sum(-1)[..., None]

    # S2: per-day first/second-minimum trick on the weekday row.
    iswd = t.weekday < 5
    c_base = sm._wd_counts(t, oh)  # [P, 5, E]
    row_present = c_base > 0
    row_np = row_present.sum(-1)
    row_min = torch.where(row_present, c_base, torch.inf).amin(-1)
    row_score = torch.where(row_np > 1, row_min, 0.0)  # [P, 5]
    s2_base = row_score.sum(-1)
    old_rs = torch.cat([row_score, row_score.new_zeros((p, 2))], dim=1)[:, t.weekday]  # 0 on weekends
    c_day = torch.cat([c_base, c_base.new_zeros((p, 2, n_emp))], dim=1)[:, t.weekday]  # [P, D, E]
    v2 = c_day - oh * iswd[:, None].to(f32)
    p2 = v2 > 0
    np2 = p2.sum(-1)
    v2m = torch.where(p2, v2, sm._BIG)
    min1 = v2m.amin(-1)
    arg1 = v2m.argmin(-1)
    at1 = iota_e == arg1[..., None]
    min2 = torch.where(at1, sm._BIG, v2m).amin(-1)
    cand2 = v2 + 1.0
    min_new = torch.where(at1, torch.minimum(cand2, min2[..., None]), torch.minimum(min1[..., None], cand2))
    np_new2 = np2[..., None] + (v2 == 0)
    rs_new = torch.where(np_new2 > 1, min_new, 0.0)
    d_s2 = iswd[:, None].to(f32) * (rs_new - old_rs[..., None])

    # S3/S4: per-day extrema tricks on totals / weekend totals.
    tot, wk = sm._totals(t, oh)
    pres_b = tot > 0
    np_b = pres_b.sum(-1)
    s3_base = sm.spread_of(tot, pres_b, np_b)
    s4_base = sm.spread_of(wk, pres_b, np_b)

    v3 = tot[:, None] - oh
    p3 = v3 > 0
    np3 = p3.sum(-1)
    v3m = torch.where(p3, v3, sm._BIG)
    min1_3 = v3m.amin(-1)
    at1_3 = iota_e == v3m.argmin(-1)[..., None]
    min2_3 = torch.where(at1_3, sm._BIG, v3m).amin(-1)
    max1_3 = torch.where(p3, v3, -sm._BIG).amax(-1)
    cand3 = v3 + 1.0
    min_new3 = torch.where(
        at1_3, torch.minimum(cand3, min2_3[..., None]), torch.minimum(min1_3[..., None], cand3)
    )
    max_new3 = torch.maximum(max1_3[..., None], cand3)
    np_new3 = np3[..., None] + (v3 == 0)
    d_s3 = torch.where(np_new3 >= 2, max_new3 - min_new3, 0.0) - s3_base[:, None, None]

    v4 = wk[:, None] - t.weekend_f[:, None] * oh
    v4m = torch.where(p3, v4, sm._BIG)
    min1_4 = v4m.amin(-1)
    at1_4 = iota_e == v4m.argmin(-1)[..., None]
    min2_4 = torch.where(at1_4, sm._BIG, v4m).amin(-1)
    v4x = torch.where(p3, v4, -sm._BIG)
    max1_4 = v4x.amax(-1)
    atx_4 = iota_e == v4x.argmax(-1)[..., None]
    max2_4 = torch.where(atx_4, -sm._BIG, v4x).amax(-1)
    cand4 = v4 + t.weekend_f[:, None]
    min_new4 = torch.where(
        at1_4, torch.minimum(cand4, min2_4[..., None]), torch.minimum(min1_4[..., None], cand4)
    )
    max_new4 = torch.where(
        atx_4, torch.maximum(cand4, max2_4[..., None]), torch.maximum(max1_4[..., None], cand4)
    )
    d_s4 = torch.where(np_new3 >= 2, max_new4 - min_new4, 0.0) - s4_base[:, None, None]

    noop = oh > 0  # e == a[d] is the identity move: exact delta 0
    d_hard = torch.where(noop, 0.0, d_h1 + d_h2 + d_h3 + d_h4)
    d_soft = torch.where(noop, 0.0, d_s1 + d_s2 + d_s3 + d_s4)

    cur_h, cur_s = cur_score[:, 0:1], cur_score[:, 1:2]
    ch_moves = (
        torch.zeros((p, d_days * n_emp), dtype=torch.bool, device=dev),
        iota_d.repeat_interleave(n_emp).expand(p, -1),
        iota_d.repeat_interleave(n_emp).expand(p, -1),
        iota_e.repeat(d_days).expand(p, -1),
    )
    # Dense batch fingerprints: fp' = fp ^ h(d, a[d]) ^ h(d, e), one K2a launch.
    fd0, fd1 = hash_xor(None, ((iota_d[:, None], a[..., None]), (iota_d[:, None], iota_e)), planes=True)
    blocks = [(
        cur_h + d_hard.reshape(p, -1), cur_s + d_soft.reshape(p, -1), ch_moves,
        torch.ones((p, d_days * n_emp), dtype=torch.bool, device=dev),
        fd0.reshape(p, -1), fd1.reshape(p, -1),
    )]

    if n_rand > 0:
        # Unrestricted random swaps: any day pair, scored by the region path.
        rs_moves = (
            torch.ones((p, n_rand), dtype=torch.bool, device=dev),
            rs_d1,
            (rs_d1 + rs_off) % d_days,
            torch.zeros((p, n_rand), dtype=torch.int64, device=dev),
        )
        rs_dh, rs_ds, (rf0, rf1) = sm.exact_move_deltas(t, a, rs_moves, n_emp, d_days)
        blocks.append((
            cur_h + rs_dh, cur_s + rs_ds, rs_moves,
            torch.ones((p, n_rand), dtype=torch.bool, device=dev), rf0, rf1,
        ))

    if n_off > 0:
        # Swap diagonals swap(d, d + delta), delta >= 14: window-disjoint, so the
        # windowed deltas decompose into the two ChangeDay deltas; S2/S4 are
        # re-derived coupled (S3 is zero: totals are unchanged).
        a_ext = torch.cat([a, a.new_full((p, d_days), -2)], dim=1)
        blk = torch.stack([d_hard, d_s1])  # [2, P, D, E]
        blk_ext = torch.cat([blk, blk.new_zeros((2, p, d_days, n_emp))], dim=2)
        wd_oh5 = sm._one_hot(t.weekday, 5)  # [D, 5], 0 on weekends
        far = iota_d + delta[..., None]  # [P, n_off, D] (>= D: padding)
        a2 = a_ext.gather(1, far.view(p, -1)).view(p, n_off, d_days)
        oh2 = sm._one_hot(a2, n_emp)  # -2 padding: a zero row
        blk_sh = blk_ext.gather(2, far.view(1, p, -1, 1).expand(2, p, -1, n_emp))
        blk_sh = blk_sh.view(2, p, n_off, d_days, n_emp)
        term_a = (blk[:, :, None] * oh2).sum(-1)      # block[d, a2]
        term_b = (blk_sh * oh[:, None]).sum(-1)       # block[d + delta, a1]

        wd2 = (t.weekday + delta[..., None]) % 7  # [P, n_off, D]
        diff = oh2 - oh[:, None]
        upd = (
            c_base[:, None, None]
            + wd_oh5[:, :, None] * diff[..., None, :]
            - sm._one_hot(wd2, 5)[..., None] * diff[..., None, :]
        )  # [P, n_off, D, 5, E]
        s2_sw = sm.s2_of(upd) - s2_base[:, None, None]
        dw = (t.weekend_f - (wd2 >= 5).to(f32))[..., None]
        s4_sw = (
            sm.spread_of(wk[:, None, None] + dw * diff, pres_b[:, None, None], np_b[:, None, None])
            - s4_base[:, None, None]
        )
        noop_sw = a2 == a[:, None]
        hard_sw = torch.where(noop_sw, 0.0, term_a[0] + term_b[0])  # [P, n_off, D]
        soft_sw = torch.where(noop_sw, 0.0, term_a[1] + term_b[1] + s2_sw + s4_sw)
        d2_sw = far.clamp(max=d_days - 1)
        d1_b = iota_d.expand(p, n_off, d_days)
        a_b = a[:, None, :].expand(p, n_off, d_days)
        f0, f1 = sm._swap_fp_delta_planes(d1_b, a_b, a2, d2_sw, a2, a_b)
        sw_moves = (
            torch.ones((p, n_off * d_days), dtype=torch.bool, device=dev),
            d1_b.reshape(p, -1),
            d2_sw.reshape(p, -1),
            torch.zeros((p, n_off * d_days), dtype=torch.int64, device=dev),
        )
        blocks.append((
            cur_h + hard_sw.reshape(p, -1), cur_s + soft_sw.reshape(p, -1), sw_moves,
            (far <= d_days - 1).reshape(p, -1), f0.reshape(p, -1), f1.reshape(p, -1),
        ))

    # The blocks (hard, soft, moves, valid, fp0, fp1), each [P, w], concatenated in order.
    cat = lambda *xs: torch.cat(xs, dim=1)  # noqa: E731
    parts = list(zip(*blocks))
    return DenseOut(
        torch.stack([cat(*parts[0]), cat(*parts[1])], dim=-1),
        cat(*parts[3]),
        torch.stack([cat(*parts[4]), cat(*parts[5])], dim=-1),
        *(cat(*m) for m in zip(*parts[2])),
    )


def build_library(force: bool = False) -> str:
    """Compile ``csrc/sched_dense.cu`` into ``build/kernels/`` if the library
    is missing, older than its sources, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    return _LIBRARY.build(force)


def sched_dense(assign, cur_score, tables, start_weekday: int, rs_d1, rs_off, delta) -> DenseOut:
    """K5: the dense neighborhood of every lane's ``assign`` int64[P, D] at
    ``cur_score`` float32[P, 2], from the draws ``rs_d1``, ``rs_off`` int64[P,
    R] and ``delta`` int64[P, O]; ``tables`` the problem's tables on the same
    device (its ``holiday_de`` float32[D, E] is read), the first day's
    weekday ``start_weekday`` (0 = Monday).  Returns a ``DenseOut``."""
    args = (assign, cur_score, tables, start_weekday, rs_d1, rs_off, delta)
    dims = check_inputs(*args)
    count = roofline.active_count()
    if count is not None:
        # Counted by formula; the ops issued below are not counted.
        with count.kernel(KERNEL_NAME, *kernel_work(*dims)):
            return _dense(args, *dims)
    return _dense(args, *dims)


def _plan_values(assign, cur_score, holiday, start_weekday: int, rs_d1, rs_off, delta, out: DenseOut, scratch,
                 flag_scratch, plan: LaunchPlan) -> list:
    """The C entry's plan (the layout in ``csrc/sched_dense.cu``)."""
    p, d = assign.shape
    e = holiday.shape[1]
    n_rand, n_off = rs_d1.shape[1], delta.shape[1]
    ptr = (lambda t: t.data_ptr() if t.numel() else 0)  # noqa: E731
    values = [p, d, e, n_rand, n_off, start_weekday, plan.slices, plan.chunk, plan.span, plan.smem,
              out.valid.shape[1], ptr(assign), assign.stride(0), ptr(cur_score), *cur_score.stride(), ptr(holiday),
              ptr(rs_d1), ptr(rs_off), ptr(delta), *rs_d1.stride(), *rs_off.stride(), *delta.stride(),
              *(ptr(t) for t in out), 0 if scratch is None else scratch.data_ptr(), int(plan.plane_shared),
              plan.swap_batch, int(plan.hol_shared), int(plan.flags_shared),
              0 if flag_scratch is None else flag_scratch.data_ptr()]
    return values + [0] * (PLAN_LEN - len(values))


def _dense(args, p: int, d: int, e: int, n_rand: int, n_off: int) -> DenseOut:
    assign, cur_score, tables, start_weekday, rs_d1, rs_off, delta = args
    device = assign.device
    if device.type == "cpu":
        return sched_dense_ref(*args)
    if d > MAX_DAYS or e > MAX_EMPS:
        raise ValueError(f"K5 takes at most {MAX_DAYS} days and {MAX_EMPS} employees, got D = {d}, E = {e}")
    width = d * e + n_rand + n_off * d
    out = DenseOut(
        cur_score.new_empty((p, width, 2)), torch.empty((p, width), dtype=torch.bool, device=device),
        assign.new_empty((p, width, 2)), torch.empty((p, width), dtype=torch.bool, device=device),
        *(assign.new_empty((p, width)) for _ in range(3)),
    )
    if p == 0:
        return out
    index = device.index
    plan = _launch_plan(p, d, e, n_rand, n_off, _sms(index))
    scratch = None if plan.plane_shared else torch.empty((p, d, e, 2), dtype=torch.int8, device=device)
    flag_scratch = (None if plan.flags_shared else
                    torch.empty((p, FLAGS, e, -(-d // 32) + 2), dtype=torch.int32, device=device))
    values = _plan_values(assign, cur_score, tables.holiday_de, start_weekday, rs_d1, rs_off, delta, out,
                          scratch, flag_scratch, plan)
    nk.launch(_LIBRARY.entry("sched_dense_launch"), ((ctypes.c_longlong * PLAN_LEN)(*values),), index,
              f"(P, D, E, R, O) = {(p, d, e, n_rand, n_off)}, {plan}")
    launch_count.count(sched_dense, (p, d, e, n_rand, n_off))
    return out


def occupancy(p: int, d: int, e: int, n_rand: int, n_off: int, device) -> dict:
    """What the card makes of the plan for (P, D, E, R, O) on CUDA ``device``,
    for a log: the plan, the kernel's registers and local (spill) bytes a
    thread, its blocks that fit an SM and the plan's clusters that the card
    holds at once.  Launches nothing."""
    device = torch.device(device)
    plan = _launch_plan(p, d, e, n_rand, n_off, _sms(device.index))
    values = [p, d, e, n_rand, n_off, 0, plan.slices, plan.chunk, plan.span, plan.smem, d * e + n_rand + n_off * d,
              *[0] * 22, int(not plan.plane_shared), int(plan.plane_shared), plan.swap_batch, int(plan.hol_shared),
              int(plan.flags_shared), int(not plan.flags_shared), 0]  # placeholder scratches: no pointer is read
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = _LIBRARY.entry("sched_dense_occupancy")((ctypes.c_longlong * PLAN_LEN)(*values), out)
    if err != 0:
        raise RuntimeError(f"sched_dense_occupancy failed: cudaError_t {err} for {plan}")
    return {**plan._asdict(), "registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "clusters_at_once": out[3]}


launch_count.counted(sched_dense)  # .launches, and .shapes per (P, D, E, R, O)
