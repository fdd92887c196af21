"""The port's profiling helpers and roofline accounting on the CPU
(``utils/profiling.py``, ``utils/roofline.py``, ``Solver.roofline``,
``PopulationSolver.roofline``).

- ``trace`` writes a Chrome trace that holds an ``annotate`` span;
- ``roofline`` gives finite positive rates and shares, and counts the N-Queens
  kernel's work by its formula (``kernel_work``, whose bytes are
  ``chip_smoke.kernel_bytes``), not the plain version's gathers that compute it
  on the CPU;
- ``roofline`` leaves the solver as it was: its state and draw source equal a
  twin's that never took one, and both go on to the same next round."""

import glob
import json
import math

import numpy as np
import pytest
import torch

import chip_smoke
from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
from constraint_solver_tpu_torch.ops import fingerprint as fp
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils import roofline as rl
from constraint_solver_tpu_torch.utils.convert import to_reference
from constraint_solver_tpu_torch.utils.profiling import annotate, trace
from test_torch_population import assert_tree_equal


def _config(**kw):
    return SolverConfig(seed="roofline", local_search_max_iterations=20, best_solutions_capacity=4,
                        all_solutions_capacity=32, **kw)


def test_trace_writes_chrome_trace_with_annotation(tmp_path):
    x = torch.arange(16.0)
    with trace(str(tmp_path)) as prof:
        with annotate("solver-phase"):
            (x * 2).sum()
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "solver-phase" in names and "aten::mul" in names
    assert any(e.name == "solver-phase" for e in prof.events())


def test_kernel_work_is_counted_by_formula():
    rng = np.random.default_rng(0)
    args = chip_smoke.kernel_inputs(rng, 3, 5, 16, "cpu")
    assert nk.kernel_work(3, 5, 16)[1] == chip_smoke.kernel_bytes(3, 5, 16)
    with rl.counting() as count:
        for _ in range(2):
            nk.nqueens_neighborhood_scores(*args)
    assert dict(count.kernels[nk.KERNEL_NAME]) == {
        "calls": 2, "flops": 2 * 9 * 3 * 5 * 16, "bytes": 2 * chip_smoke.kernel_bytes(3, 5, 16),
    }
    assert (count.flops, count.bytes) == (2 * 9 * 3 * 5 * 16, 2 * chip_smoke.kernel_bytes(3, 5, 16))
    with rl.counting() as plain:  # the plain version alone: its own ops, counted
        nk.nqueens_neighborhood_scores_ref(*args)
    assert plain.kernels == {} and plain.bytes > chip_smoke.kernel_bytes(3, 5, 16)
    assert rl.active_count() is None


def test_counting_uses_product_formulas_and_skips_views():
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with rl.counting() as count:
        a.view(8, 4).t()
    assert (count.flops, count.bytes) == (0, 0)
    with rl.counting() as count:
        torch.mm(a, b)
    assert count.flops == 2 * 4 * 8 * 3 and count.bytes == 4 * (32 + 24 + 12)
    with rl.counting() as count:
        a + 1.0
    assert count.flops == 32 and count.bytes == 4 * 64


def test_counting_indexing_moves_only_the_selected_elements():
    """Integer indexing reads and writes the elements it selects, not the whole
    tensor it indexes; a boolean index counts the whole tensors."""
    x = torch.zeros(4, 16, 16)
    lane, a, v = torch.arange(4), torch.tensor([1, 5, 7, 2]), torch.ones(4, 16)
    with rl.counting() as count:
        col = x[lane, :, a]  # [4, 16]
    assert col.shape == (4, 16) and (count.flops, count.bytes) == (64, 2 * 8 * 4 + 2 * 4 * 64)
    with rl.counting() as count:
        x[lane, :, a] = v
    assert (count.flops, count.bytes) == (64, 2 * 8 * 4 + 4 * 64 + 4 * 64)
    with rl.counting() as count:
        x.index_put_((lane, a), v, accumulate=True)  # rows: read and written
    assert (count.flops, count.bytes) == (64, 2 * 8 * 4 + 4 * 64 + 2 * 4 * 64)
    mask = torch.zeros(4, 16, 16, dtype=torch.bool)
    with rl.counting() as count:
        x[mask] = 1.0
    assert count.bytes >= 2 * x.numel() * 4


def _nqueens_solver(cls, **kw):
    problem = make_nqueens_problem(24)
    if cls is Solver:
        return Solver(problem, _config(), device="cpu")
    return PopulationSolver(problem, _config(), population=4, exchange_every=2, device="cpu", **kw)


@pytest.mark.parametrize("cls", [Solver, PopulationSolver], ids=["Solver", "PopulationSolver"])
def test_roofline_fields_and_kernel_bytes(cls, monkeypatch):
    solver = _nqueens_solver(cls)
    solver.run(max_rounds=1, chunk=1)
    calls = []
    work = nk.kernel_work
    monkeypatch.setattr(nk, "kernel_work", lambda p, a, n: calls.append((p, a, n)) or work(p, a, n))
    r = solver.roofline(chunk=2)
    assert r["chip"] == "cpu" and r["rounds"] == 1 and r["chunk"] == 2
    for key in ("flops_per_sec", "hbm_bytes_per_sec", "mfu_bf16", "mfu_f32", "hbm_frac",
                "intensity_flops_per_byte", "flops_per_round", "hbm_bytes_per_round", "wall_s"):
        assert math.isfinite(r[key]) and r[key] > 0, key
    assert "vpu_frac" not in r
    assert calls, "the chunk never called the kernel wrapper"
    kern = r["kernels"][nk.KERNEL_NAME]
    assert kern["calls"] == len(calls)
    assert kern["bytes"] == sum(chip_smoke.kernel_bytes(*shape) for shape in calls)
    assert "% of peak" in rl.format_roofline(r)


def test_roofline_on_qap_counts_the_products():
    solver = PopulationSolver(make_qap_problem(QAPSpec.random(12, seed=0)), _config(), population=2, device="cpu")
    solver.run(max_rounds=1, chunk=1)
    r = solver.roofline()
    # The dense neighborhood takes no row minimum (no K1); only the fingerprint's K2 counts as a kernel,
    # the tabu ring's push and check among them.
    assert set(r["kernels"]) == {fp.HASH_KERNEL, fp.ROWS_KERNEL, fp.PROBE_KERNEL}
    assert r["flops_per_round"] > 2 * 12**3 and r["mfu_f32"] > 0


@pytest.mark.parametrize("cls", [Solver, PopulationSolver], ids=["Solver", "PopulationSolver"])
def test_roofline_leaves_the_solver_as_it_was(cls):
    solver, twin = _nqueens_solver(cls), _nqueens_solver(cls)
    for s in (solver, twin):
        s.execute_round()
    solver.roofline(chunk=2)
    assert solver._round == twin._round == 1
    assert_tree_equal(to_reference(twin.state), to_reference(solver.state))
    assert torch.equal(solver.draws.state_dict()["generator"], twin.draws.state_dict()["generator"])
    for s in (solver, twin):
        s.execute_round()
    assert_tree_equal(to_reference(twin.state), to_reference(solver.state))


@pytest.mark.parametrize("cls", [Solver, PopulationSolver], ids=["Solver", "PopulationSolver"])
def test_roofline_of_a_solved_solver_counts_from_an_initial_state(cls):
    """Once every lane has converged the engine skips their descents, so the
    chunk is counted from a fresh initial state drawn from the solver's own
    source: the kernel is counted, and the solver's state and draw source are
    left as they were."""
    problem = make_nqueens_problem(8)
    config = SolverConfig(seed="solved", local_search_max_iterations=50, best_solutions_capacity=4,
                          all_solutions_capacity=32)
    solver = (Solver(problem, config, device="cpu") if cls is Solver
              else PopulationSolver(problem, config, population=2, device="cpu", exchange_every=1))
    solver.run(max_rounds=200, chunk=1)
    assert solver.get_best_score() == (0.0, 0.0)
    solver.run(max_rounds=2, chunk=1)  # the converged rounds
    before, gen = to_reference(solver.state), solver.draws.state_dict()["generator"].clone()
    r = solver.roofline(chunk=2)
    assert r["counted_from"] == "initial"
    assert r["kernels"][nk.KERNEL_NAME]["calls"] > 0
    assert_tree_equal(before, to_reference(solver.state))
    assert torch.equal(gen, solver.draws.state_dict()["generator"])


def test_peaks_are_the_h100s():
    assert rl.PEAKS["h100"] == rl.ChipPeaks("h100-sxm", 989.4e12, 67e12, 3.35e12)
    assert rl.detect_peaks("cpu") is rl.PEAKS["cpu"]
    assert set(rl.PEAKS) == {"h100", "cpu"}
