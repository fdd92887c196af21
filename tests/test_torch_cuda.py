"""Tests of the PyTorch port that need a CUDA device.

They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device each test skips: the CUDA kernel has no CPU mode.  The
kernel must equal its plain PyTorch version bit for bit (every value is a small
integer held in float32), and a solve on the card must equal the same solve on
the CPU from the same host-side draws."""

import numpy as np
import pytest
import torch

from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models.nqueens import build_state, make_nqueens_problem, total_conflicts
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.convert import to_reference
from constraint_solver_tpu_torch.utils.draws import TorchDraws


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(rng, p, a, n, device):
    st = build_state(torch.as_tensor(rng.integers(0, n, size=(p, n)), device=device))
    c = torch.as_tensor(np.argsort(rng.random((p, n)), axis=1)[:, :a], device=device)
    r = st.rows.gather(1, c)
    removed = (st.rc.gather(1, r) - 1) + (st.dc.gather(1, r - c + n - 1) - 1) + (st.ac.gather(1, r + c) - 1)
    cur = total_conflicts(st.rows).to(torch.float32)
    return st.rc, st.dc, st.ac, c.to(torch.int32), r.to(torch.int32), removed, cur


@pytest.mark.cuda
@pytest.mark.parametrize("p, a, n", [(256, 50, 1000), (4, 3, 8), (8, 5, 1003), (2, 3, 14000), (3, 1, 1)])
def test_cuda_kernel_matches_plain_version(cuda, p, a, n):
    args = _inputs(np.random.default_rng(n), p, a, n, cuda)
    before = nk.nqueens_neighborhood_scores.launches
    got = nk.nqueens_neighborhood_scores(*args)
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches == before + 1
    for want, g in zip(nk.nqueens_neighborhood_scores_ref(*args), got):
        assert want.dtype == g.dtype and torch.equal(want, g)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    args = list(_inputs(np.random.default_rng(0), 2, 3, 16, cuda))
    args[3] = args[3].long()
    with pytest.raises(TypeError):
        nk.nqueens_neighborhood_scores(*args)
    args[3] = args[3].int().cpu()
    with pytest.raises(ValueError):
        nk.nqueens_neighborhood_scores(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [None, False])
def test_cuda_solve_equals_cpu_solve(cuda, exact):
    def run(device):
        config = SolverConfig(
            seed="cuda-vs-cpu", local_search_max_iterations=20, best_solutions_capacity=4,
            all_solutions_capacity=32, restart_every=3, tabu_exact_filter=exact,
        )
        solver = PopulationSolver(
            make_nqueens_problem(40), config, population=6, exchange_every=2, device=device,
            draws=TorchDraws(config.seed, 6, device, draw_device="cpu"),
        )
        trace = np.concatenate([solver.execute_chunk_traced(2) for _ in range(2)])
        return to_reference(solver.state), trace

    (on_card, trace_card), (on_cpu, trace_cpu) = run(cuda), run("cpu")
    np.testing.assert_array_equal(trace_card, trace_cpu)

    def compare(a, b):
        if hasattr(a, "_fields"):
            for f in a._fields:
                compare(getattr(a, f), getattr(b, f))
        else:
            np.testing.assert_array_equal(a, b)

    compare(on_card, on_cpu)
