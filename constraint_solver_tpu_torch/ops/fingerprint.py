"""Dense 64-bit solution fingerprints, two 32-bit lanes
(port of ``constraint_solver_tpu/ops/fingerprint.py``): CUDA on the card, plain
PyTorch on the CPU.

    fp(x) = XOR_i h(i, x_i)    per lane, h = murmur3 fmix32 of the salted position
                               mixed with the value bits

so a move changes the fingerprint in O(1): ``fp' = fp ^ h(i, old) ^ h(i, new)``.

Divergence in representation only: a fingerprint is an ``int64`` tensor holding
the uint32 value in [0, 2^32), because PyTorch implements no ``>>`` for uint32 on
the CPU.  ``_mix32`` works in int64 and masks to 32 bits after every multiply
(the product wraps, and its low 32 bits stay right), so every value equals the
JAX package's uint32 bit for bit.  PyTorch has no XOR reduction either, so
``_xor_reduce`` halves the axis pairwise.

K2, the hash as two hand-written kernels (``csrc/fingerprint.cu``).  In the JAX
package XLA fuses each use of this arithmetic into one pass; eager PyTorch runs
it as 34-96 int64 passes a use, so the port has a kernel for it:

- ``hash_xor(base, terms, planes=False)`` is K2a's wrapper: ``base ^ XOR_k
  h(idx_k, val_k)`` for 1-4 (position, value) terms, both lanes, over the
  broadcast of its operands (at most 4 dimensions); ``[..., 2]``, or ``[2, ...]``
  with ``planes``.  ``fp_update``, ``position_hash`` and
  ``position_hash_planes`` are its one- and two-term forms; the descents call it
  with four terms for a two-position move.
- ``fingerprint_i32(values)`` is K2b's wrapper: each row of ``values`` [..., n]
  hashed and XOR-reduced, ``[..., 2]``; ``fingerprint_f32`` hashes float bits
  through it.  A few long rows (a grid of fewer blocks than the card's SMs at
  8 warps a row) are split over several blocks a row (``RowsPlan.splits``),
  whose parts are XOR-ed into an output zeroed on the same stream.
- ``hash_probe(ring, push_fp, fps=, base=, deltas=, valid=)`` is K2a's ring
  form, the descent's tabu ring in one launch: the push of ``push_fp`` into a
  ``TabuRing`` (``core/history.py``), then each candidate fingerprint (``fps``
  [P, W, 2], or ``base`` [P, 2] XOR ``deltas`` [P, W, 2]) tested against the
  pushed ring: ``tabu`` [P, W], or ``valid & ~tabu``.  Its plain version,
  ``hash_probe_ref``, is the ring's own ``push`` and ``is_tabu``.  The kernel
  compares fingerprints on their low 32 bits, which is the plain version's
  int64 equality for the port's fingerprints, values in [0, 2^32).
- ``nqueens_move_fp(cur_fp, cols, rows, idx)`` is K7's wrapper: the
  fingerprint after each N-Queens candidate move, ``cur_fp ^ h(col, old) ^
  h(col, new)`` for flat candidates ``idx`` [P] or [P, W] (int32 or int64,
  any strides) of a lane whose sampled columns are ``cols`` int64 [P, A] and
  whose board is ``rows`` int64 [P, n]: col = cols[idx // n], new = idx % n,
  old = rows[col]; ``cur_fp`` int64 [P, 2].  Returns int64 [*idx.shape, 2].
  Its plain version, ``nqueens_move_fp_ref``, is the decode the N-Queens
  model ran before K7 (two divisions, two gathers) and ``fp_update``; the
  candidates are flat indices in [0, A·n), as the descent's picks are.
  ``models/nqueens.py``'s ``move_fp`` calls it for ``NQMoves``: one launch a
  pick or retry, and one over the exact filter's [P, A·n].
- Each wrapper checks its operands (int32 or int64; the base int64 [..., 2]; at
  most 4 dimensions; the ring form's as its docstring says) through a plan
  that is a pure function of shapes, strides and dtypes (``_hash_plan``,
  ``_rows_plan``, ``_probe_plan``, ``_nq_move_plan``), takes the plain version for
  tensors on the CPU, and for tensors on a CUDA device launches its kernel or
  raises: there is no fallback.  The kernel reads every operand by the plan's
  strides (0 on a broadcast dimension) and width, so expanded views and int32
  bit views are taken as they are, with no copy.  Operands with no element
  give an empty result (no row positions: zeros) without a launch.
  ``.launches`` counts each wrapper's kernel launches and ``.shapes`` them per
  plan, through ``ops/launch_count.py``, so CUDA graph replays count too.  Under
  ``utils/roofline.py`` each call counts its plan's ``work`` by formula: each
  distinct operand's bytes once, however many terms pass it (``_alias``).
- The plain versions (``_ref``) are the port's eager int64 arithmetic; the
  kernels compute the same uint32 values, so the two are equal bit for bit.
- ``build_library`` compiles the kernels with ``nvcc`` into ``build/kernels/``
  at first use and loads them with ``ctypes``, through
  ``ops/nqueens_kernel.py``'s ``KernelLibrary``; each C entry takes its plan as
  one int64 array.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from constraint_solver_tpu_torch.ops import launch_count
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.utils import roofline

# Two lane salts, the JAX package's arbitrary odd constants.
_SALTS = (0x9E3779B9, 0x85EBCA77)
_M32 = 0xFFFFFFFF

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fingerprint.cu"
HASH_KERNEL = "fp_hash_xor"  # K2a
PROBE_KERNEL = "fp_hash_probe"  # K2a's ring form
ROWS_KERNEL = "fingerprint_rows"  # K2b
NQ_MOVE_KERNEL = "fp_nq_move"  # K7
_PLAN_ARGS = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]  # (const long long* plan, void* stream)
_LIB_PATH = nk._BUILD_DIR / "libfingerprint.so"
_LIBRARY = nk.KernelLibrary(_SRC, _LIB_PATH, {"fp_hash_xor_launch": _PLAN_ARGS, "fingerprint_rows_launch": _PLAN_ARGS,
                                             "fp_hash_probe_launch": _PLAN_ARGS,
                                             "fp_nq_move_launch": _PLAN_ARGS})

MAX_DIMS = 4  # dimensions of an operand or of K2a's output (csrc kDims)
MAX_TERMS = 4  # (position, value) terms of K2a (csrc kMaxTerms)
HASH_PLAN_LEN = 64  # csrc kHashPlanLen
ROWS_PLAN_LEN = 16  # csrc kRowsPlanLen
PROBE_PLAN_LEN = 36  # csrc kProbePlanLen
NQ_MOVE_PLAN_LEN = 18  # csrc kNqMovePlanLen
THREADS = 256  # threads of a block (csrc kThreads)
WARPS = THREADS // 32
PROBE_TILE = 1024  # ring slots a block stages in shared memory at once (csrc kProbeTile)
SPLIT_MIN = 64  # the fewest positions a part of a split row holds
OPS_PER_HASH = 38  # two lanes of mix32(v ^ mix32(i ^ salt)) XOR-ed in: 19 integer operations each
_WIDE = {torch.int32: 0, torch.int64: 1}  # csrc Operand.wide


# ---------------------------------------------------------------- plain versions


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def position_hash_planes_ref(idx: torch.Tensor, value_bits: torch.Tensor) -> tuple:
    """h(i, v) as two int64 planes of uint32 values (the bit patterns of
    ``idx`` and ``value_bits`` taken modulo 2^32, as the JAX package's casts
    to uint32 do)."""
    idx = idx.long() & _M32
    value_bits = value_bits.long() & _M32
    return tuple(_mix32(value_bits ^ _mix32(idx ^ salt)) for salt in _SALTS)


def position_hash_ref(idx: torch.Tensor, value_bits: torch.Tensor) -> torch.Tensor:
    """h(i, v) for both lanes: [..., 2]."""
    return torch.stack(position_hash_planes_ref(idx, value_bits), dim=-1)


def _xor_reduce(lane_hashes: torch.Tensor) -> torch.Tensor:
    """XOR-reduce [..., n, 2] over axis -2 → [..., 2], by pairwise halving."""
    x = lane_hashes
    while x.shape[-2] > 1:
        if x.shape[-2] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1, :])], dim=-2)
        half = x.shape[-2] // 2
        x = x[..., :half, :] ^ x[..., half:, :]
    return x[..., 0, :]


def fingerprint_i32_ref(values: torch.Tensor) -> torch.Tensor:
    """Fingerprint of an integer [..., n] solution vector → int64[..., 2]."""
    idx = torch.arange(values.shape[-1], device=values.device).expand(values.shape)
    return _xor_reduce(position_hash_ref(idx, values))


def fp_update_ref(
    fp: torch.Tensor, idx: torch.Tensor, old_bits: torch.Tensor, new_bits: torch.Tensor
) -> torch.Tensor:
    """O(1) update of ``fp`` [..., 2] for position ``idx`` changed old → new
    (``idx``/``old_bits``/``new_bits`` broadcastable [...])."""
    return fp ^ position_hash_ref(idx, old_bits) ^ position_hash_ref(idx, new_bits)


def nqueens_move_fp_ref(cur_fp, cols, rows, idx, update=fp_update_ref) -> torch.Tensor:
    """K7's plain version: the decode of flat candidates ``idx`` [P, ...]
    (column ``cols[idx // n]``, new row ``idx % n``, old row ``rows[col]``),
    then ``update`` of ``cur_fp`` [P, 2]: ``fp_update_ref``, or ``fp_update``
    for the chain the N-Queens model ran before K7 (K2a on the card)."""
    n = rows.shape[1]
    flat = idx.reshape(idx.shape[0], -1)
    col = cols.gather(1, flat // n)
    new, old = flat % n, rows.gather(1, col)
    fp = cur_fp.view(cur_fp.shape[0], *(1,) * (idx.dim() - 1), 2)
    return update(fp, col.view(idx.shape), old.view(idx.shape), new.view(idx.shape))


def hash_xor_ref(base, terms, planes: bool = False) -> torch.Tensor:
    """``base ^ XOR_k h(idx_k, val_k)`` for both lanes: [..., 2], or [2, ...]
    with ``planes``; ``base`` int64 [..., 2] holding values in [0, 2^32), or None."""
    lanes = None
    for idx, val in terms:
        h = position_hash_planes_ref(idx, val)
        lanes = h if lanes is None else (lanes[0] ^ h[0], lanes[1] ^ h[1])
    if base is not None:
        lanes = (lanes[0] ^ base[..., 0], lanes[1] ^ base[..., 1])
    return torch.stack(lanes, dim=0 if planes else -1)


def hash_probe_ref(ring, push_fp=None, fps=None, base=None, deltas=None, valid=None) -> tuple:
    """The ring form's plain version: ``ring.push(push_fp)`` (skipped without
    one), then ``ring.is_tabu`` of the candidates ``fps``, or ``base[:, None] ^
    deltas``; returns (the ring, tabu), or (the ring, ``valid & ~tabu``)."""
    if push_fp is not None:
        ring = ring.push(push_fp)
    tabu = ring.is_tabu(base[:, None, :] ^ deltas if fps is None else fps)
    return ring, tabu if valid is None else valid & ~tabu


# ---------------------------------------------------------------- plans


class HashPlan(NamedTuple):
    out_shape: tuple  # the broadcast of the operands' shapes
    template: tuple  # the C entry's 64 int64 entries, every pointer 0
    work: tuple[int, int]  # (operations, bytes) of one call


class RowsPlan(NamedTuple):
    lead: tuple[int, int, int]  # the row dimensions, leading 1s
    rows: int
    n: int
    strides: tuple[int, int, int, int]  # element strides, 0 on a dimension of size 1
    wide: int
    warps_per_row: int  # 1, 2, 4 or 8
    grid: int  # blocks of 256 threads: 8 // warps_per_row rows each, or rows x splits
    work: tuple[int, int]
    splits: int  # blocks a row: above 1, parts of ``chunk`` positions XOR-ed into a zeroed output
    chunk: int  # positions a part (n when not split)


class ProbePlan(NamedTuple):
    lanes: int  # P
    width: int  # W candidates a lane
    capacity: int  # T slots a ring
    per_thread: int  # candidates a thread holds: 1, 2 or 4
    chunks: int  # blocks a lane; the grid is lanes x chunks blocks of 256 threads
    tiles: int  # shared-memory tiles of PROBE_TILE slots the ring is staged in
    push: bool
    template: tuple  # the C entry's 36 int64 entries, every pointer 0
    work: tuple[int, int]  # (operations, bytes) of one call


def _wide(dtype) -> int:
    if dtype not in _WIDE:
        raise TypeError(f"fingerprint operands must be torch.int32 or torch.int64, got {dtype}")
    return _WIDE[dtype]


def _operand_strides(shape, strides, out_shape) -> tuple[int, int, int, int]:
    """An operand's element strides over the output's dimensions, padded to 4:
    0 on every dimension where the operand has size 1 or no dimension (a
    broadcast), its own stride elsewhere (itself 0 on an expanded dimension)."""
    lead = len(out_shape) - len(shape)
    own = [0] * lead + [0 if size == 1 else stride for size, stride in zip(shape, strides)]
    return (0,) * (MAX_DIMS - len(out_shape)) + tuple(own)


def _distinct(shape4, strides4) -> int:
    """Elements an operand holds under the output: the sizes of the dimensions
    it does not broadcast over."""
    return math.prod(size for size, stride in zip(shape4, strides4) if stride != 0)


@functools.lru_cache(maxsize=512)
def _hash_plan(base, operands, alias, planes: bool) -> HashPlan:
    """K2a's plan from its operands' (shape, strides, dtype): ``base`` the base
    fingerprint's or None, ``operands`` idx_0, val_0, idx_1, val_1, ... in order;
    ``alias[m]`` the first operand at operand m's address (``_alias``)."""
    if len(operands) % 2 or not 1 <= len(operands) // 2 <= MAX_TERMS:
        raise ValueError(f"hash_xor takes 1 to {MAX_TERMS} (position, value) terms, got {len(operands)} operands")
    shapes = [tuple(s) for s, _, _ in operands]
    if base is not None:
        b_shape, b_strides, b_dtype = base
        if b_dtype != torch.int64 or len(b_shape) < 1 or b_shape[-1] != 2:
            raise ValueError(f"the base fingerprint must be int64 [..., 2], got {b_dtype} {tuple(b_shape)}")
        shapes.append(tuple(b_shape[:-1]))
    out_shape = tuple(torch.broadcast_shapes(*shapes))
    if len(out_shape) > MAX_DIMS:
        raise ValueError(f"hash_xor broadcasts to at most {MAX_DIMS} dimensions, got {out_shape}")
    shape4 = (1,) * (MAX_DIMS - len(out_shape)) + out_shape
    numel = math.prod(out_shape)
    terms = len(operands) // 2
    nbytes = 16 * numel  # both lanes of every output, int64
    base_entries = [0] * 6
    base_lane = 0
    if base is not None:
        b4 = _operand_strides(b_shape[:-1], b_strides[:-1], out_shape)
        base_entries = [0, *b4, 1]
        base_lane = b_strides[-1]
        nbytes += 16 * _distinct(shape4, b4)
    entries = []
    read = set()
    for m, (shape, strides, dtype) in enumerate(operands):
        s4 = _operand_strides(shape, strides, out_shape)
        wide = _wide(dtype)
        entries += [0, *s4, wide]
        # An operand that reads the elements an earlier one read (one tensor in
        # two terms, or two views of it that broadcast alike) is read once.
        elements = (alias[m], dtype, tuple(sorted((size, st) for size, st in zip(shape4, s4) if st != 0)))
        if elements not in read:
            read.add(elements)
            nbytes += (8 if wide else 4) * _distinct(shape4, s4)
    entries += [0] * (2 * 6 * MAX_TERMS - len(entries))
    step, lane = (1, numel) if planes else (2, 1)
    template = (*shape4, numel, terms, 0, step, lane, base_lane, *base_entries, *entries)
    ops = OPS_PER_HASH * terms * numel + (2 * numel if base is not None else 0)
    return HashPlan(out_shape, template, (ops, nbytes))


@functools.lru_cache(maxsize=256)
def _rows_plan(shape, strides, dtype) -> RowsPlan:
    """K2b's plan for values of ``shape`` [..., n] (1-4 dimensions) with
    ``strides``: a group of ``warps_per_row`` warps a row, the smallest power of
    two that gives each thread at most 8 positions, at most 8."""
    if not 1 <= len(shape) <= MAX_DIMS:
        raise ValueError(f"fingerprint_i32 takes values [..., n] of 1 to {MAX_DIMS} dimensions, got {tuple(shape)}")
    wide = _wide(dtype)
    shape4 = (1,) * (MAX_DIMS - len(shape)) + tuple(shape)
    strides4 = _operand_strides(shape, strides, shape)
    lead, n = shape4[:3], shape4[3]
    rows = math.prod(lead)
    wpr = 1
    while wpr < WARPS and wpr * 256 < n:
        wpr *= 2
    per_block = WARPS // wpr
    work = (OPS_PER_HASH * rows * n, (8 if wide else 4) * _distinct(shape4, strides4) + 16 * rows)
    grid = -(-rows // per_block)
    if wpr < WARPS or grid >= nk._SMS:
        return RowsPlan(lead, rows, n, strides4, wide, wpr, grid, work, 1, n)
    # A few long rows: split each into parts of at least SPLIT_MIN positions,
    # enough of them that the grid covers every SM, no part empty.
    chunk = -(-n // min(-(-nk._SMS // rows), n // SPLIT_MIN))
    splits = -(-n // chunk)
    return RowsPlan(lead, rows, n, strides4, wide, wpr, rows * splits, work, splits, chunk)


class NqMovePlan(NamedTuple):
    lanes: int  # P
    width: int  # W candidates a lane
    template: tuple  # the C entry's 18 int64 entries, every pointer 0
    work: tuple[int, int]  # (operations, bytes) of one call


@functools.lru_cache(maxsize=256)
def _nq_move_plan(fp, cols, rows, idx) -> NqMovePlan:
    """K7's plan from its operands' (shape, strides, dtype): ``fp`` int64 [P,
    2], ``cols`` int64 [P, A], ``rows`` int64 [P, n], ``idx`` int32 or int64
    [P, W]."""
    (f_shape, f_strides, f_dtype), (c_shape, c_strides, c_dtype) = fp, cols
    (r_shape, r_strides, r_dtype), (i_shape, i_strides, i_dtype) = rows, idx
    if c_dtype != torch.int64 or r_dtype != torch.int64 or len(c_shape) != 2 or len(r_shape) != 2:
        raise ValueError(f"nqueens_move_fp: cols and rows must be int64 [P, A] and [P, n], got {c_dtype} "
                         f"{tuple(c_shape)} and {r_dtype} {tuple(r_shape)}")
    p, a = c_shape
    n = r_shape[1]
    if r_shape[0] != p or a < 1 or n < 1:
        raise ValueError(f"nqueens_move_fp: cols {tuple(c_shape)} and rows {tuple(r_shape)} of one lane each")
    if f_dtype != torch.int64 or tuple(f_shape) != (p, 2):
        raise ValueError(f"nqueens_move_fp: cur_fp must be int64 [{p}, 2], got {f_dtype} {tuple(f_shape)}")
    if len(i_shape) != 2 or i_shape[0] != p:
        raise ValueError(f"nqueens_move_fp: idx must be [{p}] or [{p}, W], got {tuple(i_shape)}")
    wide = _wide(i_dtype)
    w = i_shape[1]
    i_strides = tuple(0 if size == 1 else st for size, st in zip(i_shape, i_strides))
    template = (p, w, n, a, 0, *f_strides, 0, *c_strides, 0, *r_strides, 0, *i_strides, wide, 0)
    # Bytes: cur_fp, idx's distinct elements, the sampled columns and their
    # rows that the candidates read (at most A a lane), the output.
    sampled = p * min(w, a)
    nbytes = 16 * p + (8 if wide else 4) * _distinct(i_shape, i_strides) + 16 * sampled + 16 * p * w
    return NqMovePlan(p, w, template, ((2 * OPS_PER_HASH + 4) * p * w, nbytes))


def _probe_strides(shape, strides, want, name) -> tuple:
    """An operand's element strides over ``want`` (its shape broadcast there:
    0 on a dimension of size 1), or a ValueError naming it."""
    if len(shape) != len(want) or any(s not in (1, w) for s, w in zip(shape, want)):
        raise ValueError(f"hash_probe: {name} must be {tuple(want)}, got {tuple(shape)}")
    return tuple(0 if size == 1 else st for size, st in zip(shape, strides))


@functools.lru_cache(maxsize=256)
def _probe_plan(ring, push, base, cands, valid, alias) -> ProbePlan:
    """The ring form's plan from its operands' (shape, strides, dtype): ``ring``
    the ring's fps, iters, head, count and expiry; ``push``, ``base`` and
    ``valid`` each or None; ``cands`` the candidate fingerprints or deltas;
    ``alias[m]`` the first of the operands (ring, push, base, cands, valid; the
    ones present, in that order) at operand m's address (``_alias``)."""
    (f_shape, f_strides, f_dtype), *rest = ring
    if f_dtype != torch.int64 or len(f_shape) != 3 or f_shape[2] != 2:
        raise ValueError(f"hash_probe: the ring's fps must be int64 [P, T, 2], got {f_dtype} {tuple(f_shape)}")
    p, t = f_shape[0], f_shape[1]
    if t < 1:
        raise ValueError("hash_probe: a ring of no slot")
    c_shape, c_strides, c_dtype = cands
    if c_dtype != torch.int64 or len(c_shape) != 3 or c_shape[2] != 2:
        raise ValueError(f"hash_probe: the candidates must be int64 [P, W, 2], got {c_dtype} {tuple(c_shape)}")
    w = c_shape[1]
    dims = {"iters": ((p, t), torch.int32), "head": ((p,), torch.int32), "count": ((p,), torch.int32),
            "expiry": ((p,), torch.int32)}
    entries = [0, *_probe_strides(f_shape, f_strides, (p, t, 2), "fps")]
    operands = [((p, t, 2), tuple(entries[1:]), 8)]
    for (name, (want, dtype)), (shape, strides, got) in zip(dims.items(), rest):
        if got != dtype:
            raise ValueError(f"hash_probe: the ring's {name} must be {dtype}, got {got}")
        st = _probe_strides(shape, strides, want, name)
        entries += [0, *st]
        operands.append((want, st, 4))
    for name, operand in (("push_fp", push), ("base", base)):
        if operand is None:
            entries += [0, 0, 0]
            continue
        if operand[2] != torch.int64:
            raise ValueError(f"hash_probe: {name} must be int64, got {operand[2]}")
        st = _probe_strides(operand[0], operand[1], (p, 2), name)
        entries += [0, *st]
        operands.append(((p, 2), st, 8))
    st = _probe_strides(c_shape, c_strides, (p, w, 2), "the candidates")
    entries += [0, *st]
    operands.append(((p, w, 2), st, 8))
    if valid is None:
        entries += [0, 0, 0]
    else:
        if valid[2] != torch.bool:
            raise ValueError(f"hash_probe: valid must be torch.bool, got {valid[2]}")
        st = _probe_strides(valid[0], valid[1], (p, w), "valid")
        entries += [0, *st]
        operands.append(((p, w), st, 1))
    entries += [0] * 5  # the output and the pushed ring's four tensors
    per = next((k for k in (4, 2) if p * -(-w // (k * THREADS)) >= 2 * nk._SMS), 1)
    chunks = max(1, -(-w // (per * THREADS)))
    # Bytes: each distinct operand's elements once (in the descent ``push_fp``
    # and ``base`` are one tensor), the [P, W] output, and with a push the new ring.
    nbytes, read = p * w, set()
    for m, (shape, st, size) in enumerate(operands):
        elements = (alias[m], tuple(sorted((d, s) for d, s in zip(shape, st) if s != 0)))
        if elements not in read:
            read.add(elements)
            nbytes += size * math.prod(d for d, s in zip(shape, st) if s != 0)
    ops = 2 * p * w * t  # two word compares for each candidate and slot
    if push is not None:
        ops += 2 * p * t
        nbytes += 20 * p * t + 8 * p
    template = (p, w, t, chunks, per, *entries)
    return ProbePlan(p, w, t, per, chunks, -(-t // PROBE_TILE), push is not None, template, (ops, nbytes))


def _alias(ptrs) -> tuple:
    """For each operand address, the index of the first operand at it."""
    return tuple(map(ptrs.index, ptrs))


def _hash_values(plan: HashPlan, out, base, ptrs) -> list:
    """K2a's C plan: the template with the output's, the base's and each
    operand's own pointer ``ptrs`` (an expanded view's, not a copy's)."""
    values = list(plan.template)
    values[6] = out.data_ptr()
    if base is not None:
        values[10] = base.data_ptr()
    for m, ptr in enumerate(ptrs):
        values[16 + 6 * m] = ptr
    return values


def _rows_values(plan: RowsPlan, values, out) -> tuple:
    """K2b's C plan."""
    return (values.data_ptr(), *plan.strides, plan.wide, *plan.lead, plan.rows, plan.n, out.data_ptr(),
            plan.warps_per_row, plan.grid, plan.splits, plan.chunk)


# Where each operand's pointer goes in the ring form's C plan.
_PROBE_SLOTS = {"fps": 5, "iters": 9, "head": 12, "count": 14, "expiry": 16, "push": 18, "base": 21, "cands": 24,
                "valid": 28, "out": 31, "out_fps": 32, "out_iters": 33, "out_head": 34, "out_count": 35}


def _probe_values(plan: ProbePlan, ptrs: dict) -> list:
    """The ring form's C plan: the template with each operand's own pointer
    (``ptrs``: name → address, for the operands present)."""
    values = list(plan.template)
    for name, ptr in ptrs.items():
        values[_PROBE_SLOTS[name]] = ptr
    return values


# ---------------------------------------------------------------- the library


def build_library(force: bool = False) -> str:
    """Compile ``csrc/fingerprint.cu`` into ``build/kernels/`` if the library is
    missing, older than its source, or ``force`` is set.  Returns the
    compiler's report, or "" when the library was up to date."""
    return _LIBRARY.build(force)


def _launch(entry: str, values, device, what) -> None:
    """Call ``entry`` with the plan ``values`` on ``device``'s current stream."""
    plan = (ctypes.c_longlong * len(values))(*values)
    nk.launch(_LIBRARY.entry(entry), (plan,), device.index, what)


def _check_device(tensors):
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"fingerprint operands on {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


# ---------------------------------------------------------------- the wrappers


def hash_xor(base, terms, planes: bool = False) -> torch.Tensor:
    """K2a: ``base ^ XOR_k h(idx_k, val_k)`` for both lanes.  ``terms``: 1-4
    (idx, val) pairs of int32 or int64 tensors, any strides; ``base``: int64
    [..., 2] holding values in [0, 2^32), or None.  All broadcast together to at
    most 4 dimensions [...].  Returns int64 [..., 2], or [2, ...] with ``planes``."""
    terms = tuple(terms)
    operands = [t for pair in terms for t in pair]
    if len(operands) != 2 * len(terms):
        raise ValueError("hash_xor's terms are (position, value) pairs")
    tensors = operands if base is None else [*operands, base]
    device = _check_device(tensors)
    ptrs = tuple(t.data_ptr() for t in operands)
    plan = _hash_plan(None if base is None else (base.shape, base.stride(), base.dtype),
                      tuple((t.shape, t.stride(), t.dtype) for t in operands), _alias(ptrs), planes)
    shape = (2, *plan.out_shape) if planes else (*plan.out_shape, 2)
    if plan.template[4] == 0:
        return torch.empty(shape, dtype=torch.int64, device=device)
    count = roofline.active_count()
    if count is not None:
        # Counted by formula; the ops issued below are not counted.
        with count.kernel(HASH_KERNEL, *plan.work):
            return _hash(base, terms, ptrs, planes, device, plan, shape)
    return _hash(base, terms, ptrs, planes, device, plan, shape)


def _hash(base, terms, ptrs, planes, device, plan, shape):
    if device.type == "cpu":
        return hash_xor_ref(base, terms, planes)
    out = torch.empty(shape, dtype=torch.int64, device=device)
    _launch("fp_hash_xor_launch", _hash_values(plan, out, base, ptrs), device,
            f"{len(terms)} terms over {plan.out_shape}")
    launch_count.count(hash_xor, plan)
    return out


def fingerprint_i32(values: torch.Tensor) -> torch.Tensor:
    """K2b: the fingerprint of each integer row of ``values`` [..., n] (int32 or
    int64, 1-4 dimensions, any strides) → int64[..., 2]."""
    device = _check_device([values])
    plan = _rows_plan(values.shape, values.stride(), values.dtype)
    shape = (*values.shape[:-1], 2)
    if plan.rows == 0 or plan.n == 0:  # no row, or rows of no position: XOR over nothing is 0
        return torch.zeros(shape, dtype=torch.int64, device=device)
    count = roofline.active_count()
    if count is not None:
        with count.kernel(ROWS_KERNEL, *plan.work):
            return _rows(values, device, plan, shape)
    return _rows(values, device, plan, shape)


def _rows(values, device, plan, shape):
    if device.type == "cpu":
        return fingerprint_i32_ref(values)
    # A split row's parts are XOR-ed into the output: zeroed first, on this stream.
    out = (torch.zeros if plan.splits > 1 else torch.empty)(shape, dtype=torch.int64, device=device)
    _launch("fingerprint_rows_launch", _rows_values(plan, values, out), device, f"{plan.rows} rows of {plan.n}")
    launch_count.count(fingerprint_i32, plan)
    return out


def hash_probe(ring, push_fp=None, fps=None, base=None, deltas=None, valid=None) -> tuple:
    """K2a's ring form: push ``push_fp`` (int64 [P, 2], or None) into ``ring`` (a
    ``TabuRing``: fps int64 [P, T, 2], iters, head, count and expiry int32), then
    test each candidate against the pushed ring: the fingerprints ``fps`` int64
    [P, W, 2], or ``base`` [P, 2] XOR ``deltas`` [P, W, 2].  Returns (the pushed
    ring, bool [P, W] tabu), or with ``valid`` (bool, broadcast to [P, W]) the
    non-tabu valid candidates, ``valid & ~tabu``.  Any strides; fingerprints
    hold values in [0, 2^32)."""
    plan, ptrs, device = probe_plan(ring, push_fp, fps, base, deltas, valid)
    if plan.lanes == 0 or (plan.width == 0 and not plan.push):
        return ring, torch.zeros((plan.lanes, plan.width), dtype=torch.bool, device=device)
    count = roofline.active_count()
    if count is not None:
        with count.kernel(PROBE_KERNEL, *plan.work):
            return _probe(ring, push_fp, fps, base, deltas, valid, device, plan, ptrs)
    return _probe(ring, push_fp, fps, base, deltas, valid, device, plan, ptrs)


def probe_plan(ring, push_fp=None, fps=None, base=None, deltas=None, valid=None) -> tuple:
    """``hash_probe``'s operands checked: (its plan, each operand's address by
    name, the device)."""
    if (fps is None) == (deltas is None) or (base is None) != (deltas is None):
        raise ValueError("hash_probe takes the candidates' fingerprints, or a base and their deltas")
    cands = fps if fps is not None else deltas
    named = {"fps": ring.fps, "iters": ring.iters, "head": ring.head, "count": ring.count, "expiry": ring.expiry,
             "push": push_fp, "base": base, "cands": cands, "valid": valid}
    named = {k: v for k, v in named.items() if v is not None}
    device = _check_device(list(named.values()))
    ptrs = {k: v.data_ptr() for k, v in named.items()}
    meta = lambda t: None if t is None else (t.shape, t.stride(), t.dtype)  # noqa: E731
    plan = _probe_plan(tuple(meta(t) for t in ring[:5]), meta(push_fp), meta(base), meta(cands), meta(valid),
                       _alias(tuple(ptrs.values())))
    return plan, ptrs, device


def _probe(ring, push_fp, fps, base, deltas, valid, device, plan, ptrs):
    if device.type == "cpu":
        return hash_probe_ref(ring, push_fp, fps, base, deltas, valid)
    p, t = plan.lanes, plan.capacity
    out = torch.empty((p, plan.width), dtype=torch.bool, device=device)
    ptrs = {**ptrs, "out": out.data_ptr()}
    if plan.push:
        ring = ring._replace(fps=torch.empty((p, t, 2), dtype=torch.int64, device=device),
                             iters=torch.empty((p, t), dtype=torch.int32, device=device),
                             head=torch.empty((p,), dtype=torch.int32, device=device),
                             count=torch.empty((p,), dtype=torch.int32, device=device))
        ptrs.update(out_fps=ring.fps.data_ptr(), out_iters=ring.iters.data_ptr(), out_head=ring.head.data_ptr(),
                    out_count=ring.count.data_ptr())
    _launch("fp_hash_probe_launch", _probe_values(plan, ptrs), device,
            f"{plan.width} candidates a lane against rings of {t} over {p} lanes")
    launch_count.count(hash_probe, plan)
    return ring, out


def nqueens_move_fp(cur_fp, cols, rows, idx) -> torch.Tensor:
    """K7: the fingerprint after each N-Queens candidate move (see the module
    docstring).  ``idx`` [P] or [P, W]; returns int64 [*idx.shape, 2]."""
    if idx.dim() not in (1, 2):
        raise ValueError(f"nqueens_move_fp: idx must be [P] or [P, W], got {tuple(idx.shape)}")
    device = _check_device([cur_fp, cols, rows, idx])
    flat = idx[:, None] if idx.dim() == 1 else idx
    meta = lambda t: (t.shape, t.stride(), t.dtype)  # noqa: E731
    plan = _nq_move_plan(meta(cur_fp), meta(cols), meta(rows), meta(flat))
    shape = (*idx.shape, 2)
    if plan.lanes * plan.width == 0:
        return torch.empty(shape, dtype=torch.int64, device=device)
    count = roofline.active_count()
    if count is not None:
        with count.kernel(NQ_MOVE_KERNEL, *plan.work):
            return _nq_move(cur_fp, cols, rows, idx, flat, device, plan, shape)
    return _nq_move(cur_fp, cols, rows, idx, flat, device, plan, shape)


def _nq_move(cur_fp, cols, rows, idx, flat, device, plan, shape):
    if device.type == "cpu":
        return nqueens_move_fp_ref(cur_fp, cols, rows, idx)
    out = torch.empty(shape, dtype=torch.int64, device=device)
    values = list(plan.template)
    values[4], values[7], values[10], values[13], values[17] = (
        cur_fp.data_ptr(), cols.data_ptr(), rows.data_ptr(), flat.data_ptr(), out.data_ptr())
    _launch("fp_nq_move_launch", values, device, f"{plan.width} N-Queens candidates a lane over {plan.lanes} lanes")
    launch_count.count(nqueens_move_fp, plan)
    return out


# .launches, and .shapes per launch plan (its ``work`` is one launch's operations and bytes).
launch_count.counted(nqueens_move_fp)
launch_count.counted(hash_xor)
launch_count.counted(fingerprint_i32)
launch_count.counted(hash_probe)


# ---------------------------------------------------------------- the public forms


def position_hash_planes(idx: torch.Tensor, value_bits: torch.Tensor) -> tuple:
    """h(i, v) as two int64 planes of uint32 values (``idx`` and ``value_bits``
    taken modulo 2^32, as the JAX package's casts to uint32 do)."""
    return tuple(hash_xor(None, ((idx, value_bits),), planes=True))


def position_hash(idx: torch.Tensor, value_bits: torch.Tensor) -> torch.Tensor:
    """h(i, v) for both lanes: [..., 2]."""
    return hash_xor(None, ((idx, value_bits),))


def fp_update(
    fp: torch.Tensor, idx: torch.Tensor, old_bits: torch.Tensor, new_bits: torch.Tensor
) -> torch.Tensor:
    """O(1) update of ``fp`` [..., 2] for position ``idx`` changed old → new
    (``idx``/``old_bits``/``new_bits`` broadcastable [...])."""
    return hash_xor(fp, ((idx, old_bits), (idx, new_bits)))


def fingerprint_f32(values: torch.Tensor) -> torch.Tensor:
    """Fingerprint of a float32 [..., n] vector by its bit patterns (the int32
    view, hashed modulo 2^32)."""
    return fingerprint_i32(values.view(torch.int32))
