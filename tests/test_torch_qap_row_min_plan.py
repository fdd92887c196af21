"""K1's launch plan (``ops/qap_row_min._launch_plan``), on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py -k qap_row_min``);
its plan is a pure function of (P, n) and the tables' alignment, so its
promises are checked here against an emulation of the blocks' walks (the
kernel's ``locate`` and ``advance`` for the ring path, the grid for the ragged
one): every (lane, row a) pair scored once, against each partner b in [a+1, n)
once; shared memory within the 227 KB a block may use, two ring blocks within
an SM's 228 KB; the ring path exactly where n % 4 == 0 and the tables lie on 16
bytes; and at the three shapes the solvers give K1 the busiest SM's work within
1.10 of the mean.  A row's partners are split over the 32 lanes of a warp and
merged by a shuffle tree: an emulation of that order must give ``torch.min``'s
value and first index on rows with NaNs, ±0, ±inf and ties planted at the lane,
tile and stage edges."""

import math
import re
from collections import Counter

import numpy as np
import pytest
import torch

from constraint_solver_tpu_torch.ops import qap_row_min as qrm

SMS = 132
SMEM_LIMIT = 227 * 1024  # a block's shared memory
SM_SHARED_BYTES = 228 * 1024  # an SM's
BLOCK_RESERVED_BYTES = 1024  # kept by the card for each resident block
K1_SHAPES = [(4, 4096), (16, 1024), (64, 256)]
SHAPES = [(1, 7), (3, 130), (4, 1000), (64, 256), (16, 1024), (4, 4096), (2, 30), (5, 1003), (1, 4100),
          (65535, 4), (3, 4098), (1, 1), (2, 64), (7, 96)]


def segments(plan, p, n):
    """(block, lane, strip's first row, its tiles' first columns) of every strip
    a block scores, in the block's order."""
    strips = -(-n // qrm.ROWS)
    if plan.path == "ring":
        items = p * ((strips + 1) // 2)
        for blk in range(plan.grid[0]):
            for item in range(blk, items, plan.grid[0]):
                x, k = divmod(item, p)
                for s in (x, strips - 1 - x) if strips - 1 - x > x else (x,):
                    yield blk, k, s * qrm.ROWS, range(s * qrm.ROWS, n, qrm.COLS)
    else:
        for k in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                for s in (bx, strips - 1 - bx) if strips - 1 - bx > bx else (bx,):
                    yield bx + plan.grid[0] * k, k, s * qrm.ROWS, range(s * qrm.ROWS, n, qrm.ROWS)


def tile_width(plan):
    return qrm.COLS if plan.path == "ring" else qrm.ROWS


@pytest.mark.parametrize("p, n", SHAPES)
def test_plan_scores_every_lane_row_and_partner_once(p, n):
    plan = qrm._launch_plan(p, n)
    rows = np.zeros((p, n), dtype=np.int64)
    for _, k, a0, b0s in segments(plan, p, n):
        rows[k, a0:a0 + qrm.ROWS] += 1
        cover = np.zeros(n, dtype=np.int64)
        for b0 in b0s:
            cover[b0:b0 + tile_width(plan)] += 1  # the kernel masks the columns from n
        # Each row a of the strip (a >= a0) meets every column from a0 to n once, so b in [a+1, n) once.
        assert (cover[a0:] == 1).all() and not cover[:a0].any()
    assert (rows == 1).all()


@pytest.mark.parametrize("p, n", SHAPES)
def test_plan_shared_memory(p, n):
    plan = qrm._launch_plan(p, n)
    assert 0 <= plan.smem_bytes <= SMEM_LIMIT
    if plan.path == "ring":
        assert plan.smem_bytes == 4 * qrm.STAGES * qrm.STAGE_FLOATS and plan.stages >= 3
        assert qrm.BLOCKS_PER_SM * (plan.smem_bytes + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
        assert plan.block == (qrm.THREADS, 1) and 1 <= plan.grid[0] <= qrm.BLOCKS_PER_SM * SMS
    else:
        assert plan.smem_bytes == 0 and plan.stages == 0 and plan.block == (32, 8)


@pytest.mark.parametrize("p, n", SHAPES)
def test_ring_path_exactly_where_rows_lie_on_16_bytes(p, n):
    assert (qrm._launch_plan(p, n).path == "ring") == (n % 4 == 0)
    assert qrm._launch_plan(p, n, False).path == "ragged"


def test_ring_stages_keep_64_kb_in_flight_an_sm_at_the_main_shape():
    """While one stage is scored the other two are in flight: at (4, 4096)
    every SM holds two blocks' worth of them."""
    plan = qrm._launch_plan(4, 4096)
    stage_bytes = plan.smem_bytes // plan.stages
    assert plan.grid[0] > SMS and (plan.stages - 1) * stage_bytes * 2 >= 64 * 1024
    # The copies of one tile: three 32 x 64 tables and the 64 x 32 transposed one.
    assert 4 * (3 * qrm.ROWS * qrm.COLS + qrm.COLS * qrm.ROWS) <= stage_bytes


@pytest.mark.parametrize("p, n", K1_SHAPES)
def test_busiest_sm_within_a_tenth_of_the_mean(p, n):
    """Work a block: the bytes its tiles copy (each table's rows and columns
    below n); blocks go to SMs in turn, two at most on each."""
    plan = qrm._launch_plan(p, n)
    assert plan.path == "ring" and plan.grid == (256, 1)  # 256 items, one a block
    work = Counter()
    for blk, _, a0, b0s in segments(plan, p, n):
        rows = min(qrm.ROWS, n - a0)
        work[blk % SMS] += sum(4 * rows * min(qrm.COLS, n - b0) * 4 for b0 in b0s)
    mean = sum(work.values()) / SMS
    assert max(work.values()) <= 1.10 * mean


def test_plan_at_the_solvers_shapes():
    ring = qrm.LaunchPlan("ring", (256, 1), (256, 1), 3, 102_576)
    assert [qrm._launch_plan(p, n) for p, n in K1_SHAPES] == [ring] * 3
    assert qrm._launch_plan(5, 1003) == qrm.LaunchPlan("ragged", (16, 5), (32, 8), 0, 0)
    assert qrm._launch_plan(65535, 4).grid == (264, 1)


def test_plan_mirrors_the_kernel_source():
    """The ring's geometry in ``csrc/qap_row_min.cu`` is the plan's."""
    src = qrm._SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kT"), const("kCols"), const("kStages"), const("kWarp")) == (qrm.ROWS, qrm.COLS, qrm.STAGES, 32)
    assert "kHtStride = kT + 4;" in src and "kCur = kHaa + kT;" in src and "kStageFloats = kCur + 4;" in src
    assert f"// {qrm.STAGE_FLOATS:,}" in src and f"// {4 * qrm.STAGES * qrm.STAGE_FLOATS:,}" in src
    assert "__launch_bounds__(kThreads, 2)" in src and "cp.async.cg.shared.global" in src


# ---- the lane partition and the shuffle merge ----

def better(v, i, bv, bi):
    """The kernel's ``better``: torch.min's order on (value, index)."""
    if math.isnan(v):
        return not math.isnan(bv) or i < bi
    if math.isnan(bv):
        return False
    return v < bv or (v == bv and i < bi)


def kernel_row_min(w, a, a0):
    """Row a of the strip from a0 as a warp takes it: lane (b - a0) % 32 scans
    its partners b > a upward, then ``warp_best``'s shuffle-down tree (a lane
    past the end reads its own pair)."""
    lanes = [(math.inf, 0)] * 32
    for b in range(a + 1, len(w)):
        x = (b - a0) % 32
        if better(float(w[b]), b, *lanes[x]):
            lanes[x] = (float(w[b]), b)
    off = 16
    while off:
        lanes = [lanes[x + off] if x + off < 32 and better(*lanes[x + off], *lanes[x]) else lanes[x]
                 for x in range(32)]
        off //= 2
    return lanes[0]


def planted_rows(n, a0):
    """(name, row a, w) with w[b] for b > a: ties, signed zeros, NaNs, ±inf at
    the lane, tile and stage edges."""
    rng = np.random.default_rng(7)
    rows = []
    a = a0 + 1
    w = np.ones(n, np.float32)
    rows.append(("all ties", a, w))
    w = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0)).astype(np.float32)
    rows.append(("signed zeros", a, w))
    for edges in ((a0 + 31, a0 + 32), (a0 + 63, a0 + 64), (a0 + 64, a0 + 127), (a0 + 95, a0 + 96)):
        if edges[1] >= n:
            continue
        w = rng.normal(0.0, 1.0, n).astype(np.float32)
        w[list(edges)] = -5.0
        rows.append((f"tie at {edges}", a, w))
        w = w.copy()
        w[list(edges)] = np.nan
        rows.append((f"NaNs at {edges}", a, w))
        for zeros in ((0.0, -0.0), (-0.0, 0.0)):
            w = np.ones(n, np.float32)
            w[list(edges)] = zeros
            rows.append((f"{zeros} at {edges}", a, w))
    w = np.full(n, np.inf, np.float32)
    rows.append(("all inf", a, w))
    w = np.full(n, np.inf, np.float32)
    w[[a0 + 33, n - 1]] = -np.inf
    rows.append(("-inf twice", a, w))
    rows.append(("last row", n - 1, np.zeros(n, np.float32)))
    rows.append(("row before the last", n - 2, rng.normal(0.0, 1.0, n).astype(np.float32)))
    return rows


@pytest.mark.parametrize("n, a0", [(200, 32), (160, 0), (1003, 960)])
def test_lane_partition_and_merge_give_torch_min(n, a0):
    for name, a, w in planted_rows(n, a0):
        if a >= n:
            continue
        masked = torch.from_numpy(w.copy())
        masked[: a + 1] = torch.inf
        want_v, want_i = torch.min(masked, dim=0)
        got_v, got_i = kernel_row_min(w, a, a0)
        got = torch.tensor(got_v, dtype=torch.float32)
        assert got_i == int(want_i), name
        if math.isnan(got_v):
            assert bool(want_v.isnan()), name
        else:
            assert got.view(torch.int32) == want_v.view(torch.int32), name
