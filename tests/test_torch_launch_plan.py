"""The N-Queens kernel's launch plan (``ops/nqueens_kernel._launch_plan``), on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``); its plan is a
pure function of (P, A, n), so its promises are checked here: block (bx, p),
warp w handles column bx·G + w of lane p when that is below A, every (lane,
column) pair exactly once; shared memory within the 227 KB a block may use;
the tables staged up to n = 11,617 and read from global memory above; 16-byte
stores exactly where n % 4 == 0; and enough blocks for the card's 132 SMs
wherever P·A allows it."""

from collections import Counter

import pytest

from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

SMEM_LIMIT = 227 * 1024
STAGED_MAX_N = 11_617
SHAPES = [
    (256, 50, 1000), (1, 1000, 1000), (4, 64, 64), (4, 3, 8), (8, 5, 1003), (2, 3, 14000), (3, 1, 1),
    (1, 1, 1), (3, 13, 1000), (32, 13, 1000), (16, 50, 1001), (2, 3, STAGED_MAX_N), (2, 3, STAGED_MAX_N + 1),
    (1, 7, 100_000), (65535, 1, 4), (1, 4096, 16),
]


@pytest.mark.parametrize("p, a, n", SHAPES)
def test_plan_covers_every_lane_and_column_once(p, a, n):
    plan = nk._launch_plan(p, a, n)
    g, (gx, gy) = plan.cols_per_block, plan.grid
    assert 1 <= g <= 8 and gy == p
    handled = Counter(
        (lane, bx * g + w) for lane in range(min(p, 3)) for bx in range(gx) for w in range(g) if bx * g + w < a
    )
    assert set(handled) == {(lane, j) for lane in range(min(p, 3)) for j in range(a)}
    assert set(handled.values()) == {1}
    assert (gx - 1) * g < a  # no block without a column


@pytest.mark.parametrize("p, a, n", SHAPES)
def test_plan_shared_memory_and_staging(p, a, n):
    plan = nk._launch_plan(p, a, n)
    assert 0 <= plan.smem_bytes <= SMEM_LIMIT
    assert plan.staged == (n <= STAGED_MAX_N)
    if plan.staged:  # room for the three tables, each up to 3 floats off 16 bytes
        assert plan.smem_bytes >= 4 * ((n + 3) + 2 * (2 * n - 1 + 3))
        assert plan.smem_bytes % 16 == 0
    else:
        assert plan.smem_bytes == 0
    assert plan.vector == (n % 4 == 0)


@pytest.mark.parametrize("p, a, n", SHAPES)
def test_plan_fills_the_card_where_it_can(p, a, n):
    plan = nk._launch_plan(p, a, n)
    gx, gy = plan.grid
    assert gx * gy >= min(132, p * a)
    assert plan.cols_per_block < 2 * a or plan.cols_per_block == 1  # no block wider than twice A


@pytest.mark.parametrize("n", [1, 2, 4, 8, 1000, STAGED_MAX_N, STAGED_MAX_N + 1])
def test_plan_for_one_lane_and_one_column(n):
    plan = nk._launch_plan(1, 1, n)
    assert plan.cols_per_block == 1 and plan.grid == (1, 1)


def test_plan_at_the_main_and_pmc_shapes():
    main = nk._launch_plan(256, 50, 1000)
    assert main == nk.LaunchPlan(8, (7, 256), 20096, True, True)
    pmc = nk._launch_plan(1, 1000, 1000)
    assert pmc.cols_per_block == 4 and pmc.grid == (250, 1) and pmc.staged and pmc.vector
    assert nk._launch_plan(2, 3, 14000).staged is False
