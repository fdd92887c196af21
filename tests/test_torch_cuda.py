"""Tests of the PyTorch port that need a CUDA device.

They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device each test skips: the CUDA kernel has no CPU mode.  The
kernel must equal its plain PyTorch version bit for bit (every value is a small
integer held in float32) at every launch plan (columns per block, staged or
not, 16- or 4-byte stores) and for inputs that are views with a storage
offset, and a solve on the card must equal the same solve on
the CPU from the same host-side draws: N-Queens, PMC (the kernel's second
caller), the dense scheduling block, QAP in its three modes and the diagram
layout.  The incremental QAP state must stay exact on the card.  The user
surface runs on the card too: the nqueens CLI launches the kernel, the HTTP
service answers a round, the roofline counts the kernel's launches, and
threads that reach the kernel's first use together build it once.  Two gloo
ranks sharing the card run the pop- and nbr-sharded N-Queens solves, equal to
the same sharded solves on the CPU (the rank bodies are in
``tests/torch_ranks.py``)."""

import datetime

import numpy as np
import pytest
import torch

from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models.diagram_layout import DiagramLayoutSpec, make_diagram_layout_problem
from constraint_solver_tpu_torch.models.nqueens import build_state, make_nqueens_problem, total_conflicts
from constraint_solver_tpu_torch.models.nqueens_parallel import pmc_solve
from constraint_solver_tpu_torch.models.qap import QAPSpec, make_qap_problem
from constraint_solver_tpu_torch.models.scheduling import ScheduleSpec, make_scheduling_problem
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


STAGED_MAX_N = 11_617  # the largest n whose tables fit in a block's shared memory


@pytest.mark.cuda
@pytest.mark.parametrize(
    "p, a, n",
    [
        (256, 50, 1000), (1, 1000, 1000), (4, 64, 64), (4, 3, 8), (8, 5, 1003), (2, 3, 14000), (3, 1, 1),
        # A not a multiple of the plan's columns per block (1, 2, 4 and 8 warps)
        (3, 13, 1000), (32, 13, 1000), (16, 50, 1000), (128, 50, 1000),
        # n % 4 != 0 at a large A: 4-byte stores
        (16, 50, 1001),
        # n just below and just above the staging threshold, with and without 16-byte stores
        (2, 3, STAGED_MAX_N - 1), (2, 3, STAGED_MAX_N), (2, 3, STAGED_MAX_N + 1), (2, 3, STAGED_MAX_N + 3),
    ],
)
def test_cuda_kernel_matches_plain_version(cuda, p, a, n):
    args = _inputs(np.random.default_rng(n), p, a, n, cuda)
    before = nk.nqueens_neighborhood_scores.launches
    got = nk.nqueens_neighborhood_scores(*args)
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches == before + 1
    for want, g in zip(nk.nqueens_neighborhood_scores_ref(*args), got):
        assert want.dtype == g.dtype and torch.equal(want, g)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("p, a, n", [(256, 50, 1000), (16, 50, 1001), (2, 3, 14000)])
def test_cuda_kernel_takes_views_with_a_storage_offset(cuda, p, a, n, offset):
    """Contiguous views that start ``offset`` elements into their storage, so
    no table row is on 16 bytes: the wrapper documents that it takes them, and
    the kernel gives the plain version's bits."""
    args = _inputs(np.random.default_rng(offset), p, a, n, cuda)

    def shifted(t):
        view = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.storage_offset() == offset
        return view

    got = nk.nqueens_neighborhood_scores(*(shifted(t) for t in args))
    torch.cuda.synchronize()
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
    compare(on_card, on_cpu)


def compare(a, b):
    if hasattr(a, "_fields"):
        for f in a._fields:
            compare(getattr(a, f), getattr(b, f))
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sample_cols", [None, 16])
def test_cuda_pmc_launches_the_kernel_and_equals_cpu(cuda, sample_cols):
    def run(device):
        draws = TorchDraws("pmc", 4, device, draw_device="cpu")
        return pmc_solve(64, draws, max_steps=300, sample_cols=sample_cols)

    before = nk.nqueens_neighborhood_scores.launches
    on_card = run(cuda)
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches > before
    compare(to_reference(on_card), to_reference(run("cpu")))
    assert torch.equal(on_card.score.cpu(), total_conflicts(on_card.state.rows).cpu().float())


@pytest.mark.cuda
@pytest.mark.parametrize("proposer", ["dense", "random"])
def test_cuda_scheduling_block_equals_cpu(cuda, proposer):
    d0 = datetime.date(2024, 1, 1)
    hol = {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % 365) for k in range(10)] for e in range(20)}
    spec = ScheduleSpec.from_dates(d0, d0 + datetime.timedelta(days=364), 20, hol)
    problem = make_scheduling_problem(spec, proposer=proposer, n_rand_swaps=256)

    def block(device):
        draws = TorchDraws("sched", 8, device, draw_device="cpu")
        assign = problem.init(draws)
        nb = problem.neighborhood(assign, problem.score(assign), draws, torch.ones(8, dtype=torch.bool, device=device))
        return [x.cpu() for x in (nb.scores, nb.valid, nb.fp_deltas, *nb.moves)]

    for got, want in zip(block(cuda), block("cpu")):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _qap_run(device, n, **kw):
    config = SolverConfig(
        seed="qap-cuda", local_search_max_iterations=30, best_solutions_capacity=4, all_solutions_capacity=64,
        all_solution_iteration_expiry=1000, restart_every=3,
    )
    solver = PopulationSolver(
        make_qap_problem(QAPSpec.random(n, seed=0), **kw), config, population=6, exchange_every=2, device=device,
        draws=TorchDraws(config.seed, 6, device, draw_device="cpu"),
    )
    trace = np.concatenate([solver.execute_chunk_traced(2) for _ in range(2)])
    return solver, trace


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{}, {"compact": True}, {"incremental": True}], ids=["dense", "compact", "incremental"])
def test_cuda_qap_equals_cpu(cuda, mode):
    """QAP at n=64 from host-side draws: every score is an exact integer and
    every product exact in FP32, so the card's run equals the CPU's."""
    (on_card, trace_card), (on_cpu, trace_cpu) = _qap_run(cuda, 64, **mode), _qap_run("cpu", 64, **mode)
    np.testing.assert_array_equal(trace_card, trace_cpu)
    compare(to_reference(on_card.state), to_reference(on_cpu.state))


@pytest.mark.cuda
def test_cuda_qap_incremental_state_stays_exact(cuda):
    """The carried G and H of every lane after 4 rounds at n=512 equal
    D[p][:, p] and F G, computed apart (a host gather, a float64 product)."""
    n = 512
    solver, _ = _qap_run(cuda, n, incremental=True)
    flow, dist = QAPSpec.random(n, seed=0).arrays()
    st = solver.state.current_state
    for k, p in enumerate(st.p.cpu().numpy()):
        g = dist[np.ix_(p, p)]
        np.testing.assert_array_equal(st.g[k].cpu().numpy(), g)
        np.testing.assert_array_equal(st.h[k].cpu().numpy().astype(np.float64), flow.astype(np.float64) @ g)


@pytest.mark.cuda
def test_cuda_diagram_layout_equals_cpu(cuda):
    def run(device):
        config = SolverConfig(
            seed="diagram-cuda", local_search_max_iterations=20, best_solutions_capacity=4,
            all_solutions_capacity=64, restart_every=3,
        )
        solver = PopulationSolver(
            make_diagram_layout_problem(DiagramLayoutSpec.random(12, 16, 10, seed=2)), config, population=4,
            exchange_every=2, device=device, draws=TorchDraws(config.seed, 4, device, draw_device="cpu"),
        )
        trace = np.concatenate([solver.execute_chunk_traced(2) for _ in range(2)])
        return to_reference(solver.state), trace

    (on_card, trace_card), (on_cpu, trace_cpu) = run(cuda), run("cpu")
    np.testing.assert_array_equal(trace_card, trace_cpu)
    compare(on_card, on_cpu)


@pytest.mark.cuda
def test_cuda_nqueens_cli_launches_the_kernel(cuda, capsys):
    from constraint_solver_tpu_torch.cli import nqueens

    before = nk.nqueens_neighborhood_scores.launches
    assert nqueens.main(["--board-size", "64", "--device", "cuda", "--quiet"]) == 0
    torch.cuda.synchronize()
    assert nk.nqueens_neighborhood_scores.launches > before
    assert "result.score: 0" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_service_round(cuda):
    from constraint_solver_tpu_torch.serve.server import SolverService

    service = SolverService("cuda")
    sid = service.create({"problem": "nqueens", "boardSize": 32, "seed": "serve"})
    before = nk.nqueens_neighborhood_scores.launches
    r = service.round(sid)
    rows = np.array(r["result"]["rows"])
    assert nk.nqueens_neighborhood_scores.launches > before
    assert r["result"]["score"]["hard_score"] == float(total_conflicts(torch.as_tensor(rows)))
    service.delete(sid)


@pytest.mark.cuda
def test_cuda_roofline_counts_the_kernel_launches(cuda):
    solver = PopulationSolver(
        make_nqueens_problem(64), SolverConfig(seed="roofline", local_search_max_iterations=20), population=8,
        exchange_every=2, device=cuda,
    )
    solver.run(max_rounds=1, chunk=1)
    before = nk.nqueens_neighborhood_scores.launches
    r = solver.roofline()
    launches = nk.nqueens_neighborhood_scores.launches - before
    kern = r["kernels"][nk.KERNEL_NAME]
    assert r["chip"] == "h100-sxm" and launches > 0 and kern["calls"] == launches
    assert kern["bytes"] == launches * nk.kernel_work(8, 64 // 20, 64)[1]
    assert all(0 < r[k] <= 1.05 for k in ("mfu_bf16", "mfu_f32", "hbm_frac"))


@pytest.mark.cuda
def test_cuda_concurrent_first_use_builds_once(cuda, tmp_path, monkeypatch):
    """Threads reach the kernel's first use together: ``nvcc`` runs once and
    every thread launches the one library."""
    import threading

    monkeypatch.setattr(nk, "_LIB_PATH", tmp_path / "libnqueens_scores.so")
    monkeypatch.setattr(nk, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nk, "_launch_fn", None)
    compiles = []
    run = nk.subprocess.run
    monkeypatch.setattr(nk.subprocess, "run", lambda cmd, **kw: compiles.append(cmd) or run(cmd, **kw))
    args = _inputs(np.random.default_rng(0), 4, 5, 64, cuda)
    want = nk.nqueens_neighborhood_scores_ref(*args)
    barrier = threading.Barrier(4)
    got, errors = [], []

    def first_use():
        try:
            barrier.wait(timeout=60)
            out = nk.nqueens_neighborhood_scores(*args)
            torch.cuda.synchronize()
            got.append(out)
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(compiles) == 1 and len(got) == 4
    for out in got:
        assert all(torch.equal(w, g) for w, g in zip(want, out))


@pytest.mark.cuda
def test_cuda_sharded_solves_equal_cpu(cuda, tmp_path):
    import torch_ranks

    ranks = torch_ranks.spawn(torch_ranks.cuda_sharded_body, 2, tmp_path, 48, 8, device="cuda:0")
    for out in ranks:
        for name in ("pop", "nbr"):
            card, cpu = out[(name, "cuda")], out[(name, "cpu")]
            np.testing.assert_array_equal(card["traces"], cpu["traces"])
            for want, got in zip(torch_ranks.tree_leaves_np(cpu["state"]), torch_ranks.tree_leaves_np(card["state"])):
                np.testing.assert_array_equal(got, want)
            assert card["launches"] > 0 and cpu["launches"] == 0
